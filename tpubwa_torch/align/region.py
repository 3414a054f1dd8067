"""Alignment regions (the ``AlnReg`` of ``tpubwa.align.region``).

The flat native engine (``align/flatext.py``) produces regions as columns;
the per-read generator tier of ``align/finalize.py`` and ``align/pair.py``
works on these objects.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AlnReg:
    """Alignment region (bwa mem_alnreg_t)."""

    rb: int = 0           # [rb, re): reference in 2*l_pac coords
    re: int = 0
    qb: int = 0           # [qb, qe): query
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    frac_rep: float = 0.0
    hash: int = 0
