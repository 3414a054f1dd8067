"""Faults planted where the timed path writes its SAM, for the readings that
a cell's limits are set from (``portbench.calibrate``) and for the tests
that see ``correct`` come out false.  The benchmark's own runs do not use
them.

- ``mapq0``: every primary record's MAPQ written as 0;
- ``mapq60``: every mapped primary record's MAPQ written as 60;
- ``unpaired``: flag 2 (proper pair) taken off every record.
"""
from __future__ import annotations


def alter_sam(text: str, kind: str) -> str:
    """`text` (SAM records) with the fault `kind` planted in it."""
    out = []
    for line in text.split("\n"):
        f = line.split("\t")
        if len(f) > 9 and line[0] != "@":
            flag = int(f[1])
            if kind == "unpaired":
                f[1] = str(flag & ~2)
            elif not flag & 0x900:
                if kind == "mapq0":
                    f[4] = "0"
                elif kind == "mapq60" and not flag & 4:
                    f[4] = "60"
                elif kind not in ("mapq0", "mapq60"):
                    raise ValueError(f"no fault {kind!r}")
            line = "\t".join(f)
        out.append(line)
    return "\n".join(out)
