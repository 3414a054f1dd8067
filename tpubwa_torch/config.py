"""Alignment options — the equivalent of bwa-mem's ``mem_opt_t``.

Defaults mirror bwa-mem2's ``mem_opt_init()`` (reference: [src] bwamem.cpp;
surveyed via SURVEY.md §5 "Config / flag system": CLI flags `-t`, `-k`, and
hard-coded tunables `MAX_SEED_HITS`, `BATCH_THRESHOLD`, `MAX_SEQ_LEN8` are all
surfaced here as config fields).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class MemOptions:
    # scoring
    a: int = 1                  # match score
    b: int = 4                  # mismatch penalty
    o_del: int = 6              # gap open (deletion)
    e_del: int = 1              # gap extend (deletion)
    o_ins: int = 6              # gap open (insertion)
    e_ins: int = 1              # gap extend (insertion)
    pen_unpaired: int = 17      # phred-scaled penalty for unpaired reads
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                # band width
    zdrop: int = 100            # Z-dropoff

    # seeding
    min_seed_len: int = 19
    split_width: int = 10
    split_factor: float = 1.5
    max_mem_intv: int = 20      # 3rd-round (LAST-like) seeding occ cap; 0 disables
    max_occ: int = 500          # skip a seed if its SMEM has more occurrences

    # chaining
    max_chain_gap: int = 10000
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    mask_level_redun: float = 0.95

    # output
    T: int = 30                 # minimum score to output
    mapQ_coef_len: int = 50
    max_XA_hits: int = 5
    XA_drop_ratio: float = 0.80

    # pairing
    max_ins: int = 10000
    max_matesw: int = 50

    # pipeline / device batching (TPU-specific; no reference analog except
    # kthread batch sizes — SURVEY.md §2 kt_for ARM_BATCH_SIZE lesson: small
    # balanced batches)
    batch_reads: int = 8192        # reads per device batch
    mesh_shape: tuple = ()         # device mesh for data-parallel sharding
    #                                (empty = single device)
    shard_sa: bool = False         # shard the suffix array over the mesh
    #                                (GRCh38-scale serving: the SA doesn't
    #                                fit one chip; ops.fm.sa_lookup_sharded)
    sa_sample_shift: int = 0       # sampled-SA serving: keep every SA row
    #                                whose suffix position % 2^shift == 0
    #                                on device (1/2^shift the HBM) and
    #                                LF-walk the rest (<= 2^shift-1 fused
    #                                gathers/lookup, exact results) — the
    #                                single-chip route for genomes whose
    #                                full SA exceeds HBM (ops.fm
    #                                sa_lookup_sampled).  0 = full SA.
    max_read_len: int = 160        # static padded read length on device
    max_smems_per_read: int = 64   # static SMEM capacity per read
    max_seeds_per_read: int = 128  # static seed capacity per read
    pad_tail_full: bool = False    # pad tail batches to batch_reads so the
    #                                whole run uses ONE seeding shape family
    #                                (each extra shape costs ~50 s of cold
    #                                TPU compile; a padded tail costs <1 s
    #                                of masked device work).  Set by the
    #                                production presets; off by default so
    #                                small API/test batches stay small.

    @property
    def mapQ_coef_fac(self) -> float:
        return math.log(self.mapQ_coef_len)

    @classmethod
    def preset(cls, name: str, **overrides) -> "MemOptions":
        """Topology presets — the reference's runtime dispatcher picked a
        fat binary per CPU generation ([src] runsimd_arm.cpp, SURVEY.md
        §2.1); here the moral equivalent is a device-batch / mesh config
        per TPU topology."""
        presets = {
            # host-only development (CPU, possibly a virtual device mesh)
            "cpu-dev": dict(batch_reads=256, pad_tail_full=True),
            # one v5e chip
            "v5e-1": dict(batch_reads=8192, pad_tail_full=True),
            # single-host 4-chip slice: reads data-parallel over ICI
            "v5e-4": dict(batch_reads=32768, mesh_shape=(4,), pad_tail_full=True),
            # 16-chip pod slice
            "v5e-16": dict(batch_reads=65536, mesh_shape=(16,), pad_tail_full=True),
        }
        if name not in presets:
            raise ValueError(
                f"unknown preset {name!r}; choose from {sorted(presets)}")
        cfg = dict(presets[name])
        cfg.update(overrides)
        return cls(**cfg)

    @property
    def split_len(self) -> int:
        # bwa: (int)(opt->min_seed_len * opt->split_factor + .499)
        return int(self.min_seed_len * self.split_factor + 0.499)

    def score_matrix(self) -> np.ndarray:
        """5x5 scoring matrix (bwa_fill_scmat): ACGT x ACGT, row/col 4 = N.
        Memoized per (a, b) — it is requested on hot per-read paths."""
        key = (self.a, self.b)
        cached = getattr(self, "_scmat", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        mat = np.full((5, 5), -1, dtype=np.int32)
        for i in range(4):
            for j in range(4):
                mat[i, j] = self.a if i == j else -self.b
        mat[4, :] = -1
        mat[:, 4] = -1
        object.__setattr__(self, "_scmat", (key, mat))
        return mat
