"""SAM output formatting (host side).

Reference analog: the SAM-record construction half of worker_sam
(bwamem.cpp mem_aln2sam; SURVEY.md §3.1 "PAIRING+SAM").  Field layout must
match bwa-mem2: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL
then tags NM, MD, AS, XS, [SA], [XA].
"""
from __future__ import annotations

import dataclasses

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

CIGAR_OPS = "MIDSH"  # op codes 0..4 as used internally


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based leftmost position; 0 if unmapped
    mapq: int
    cigar: str
    rnext: str
    pnext: int
    tlen: int
    seq: str
    qual: str
    tags: list[str]

    def line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            self.rnext,
            str(self.pnext),
            str(self.tlen),
            self.seq,
            self.qual if self.qual else "*",
        ]
        fields.extend(self.tags)
        return "\t".join(fields)


def sam_header(contigs, prog_cl: str, version: str) -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for c in contigs:
        lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
    lines.append(
        f"@PG\tID:tpu-bwa\tPN:tpu-bwa\tVN:{version}\tCL:{prog_cl}")
    return "\n".join(lines) + "\n"


def cigar_string(ops: list[tuple[int, int]]) -> str:
    """ops: list of (op_code, length) with op codes indexing CIGAR_OPS."""
    if not ops:
        return "*"
    return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in ops)
