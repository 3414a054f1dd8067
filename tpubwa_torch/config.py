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


@dataclasses.dataclass(frozen=True)
class Widths:
    """The device widths a read batch runs at, chosen by its padded width
    (``batch_widths``): a batch of reads no longer than
    ``max_read_len`` takes the narrow bucket, a batch holding a longer one
    (up to ``LONG_READ_LEN``, 2x250 Illumina) the wide one, every read of
    it padded to ``LONG_READ_LEN`` (``batch_width``).  The widths cut
    nothing that a read of the bucket needs: the extension's query
    window holds the read, the SAM windows its record, the rescue target
    bwa's window (insert range plus the read)."""

    ext_q: int       # extension query window (ops/extend_flat.py Q_PAD)
    sam_q: int       # flat SAM query window (align/flatsam.py QPAD)
    sam_t: int       # flat SAM reference window (align/flatsam.py TWIN)
    rescue_q: int    # mate-rescue query pad (align/pair.py)
    rescue_t: int    # mate-rescue target pad
    seed_scale: int  # seeding capacities: max_smems_per_read and
    #                  max_seeds_per_read times this
    seed_rows: int   # the batch's seed rows, a read on average
    #                  (ops/seeds.py rows_per_read)


# the longest read the port aligns: the wide bucket's padded width
LONG_READ_LEN = 256
NARROW = Widths(ext_q=192, sam_q=192, sam_t=256, rescue_q=192,
                rescue_t=1024, seed_scale=1, seed_rows=32)
# TWIN 256 + the band 100, rounded up; 2,048 holds bwa's rescue window
# (about 1,200 at an insert of 550 +- 100) with room
WIDE = Widths(ext_q=256, sam_q=256, sam_t=384, rescue_q=256, rescue_t=2048,
              seed_scale=2, seed_rows=64)


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


def batch_width(max_len: int, lens) -> int:
    """The width a batch of reads `lens` bp long is padded to, the one
    rule of the buckets: `max_len` (``MemOptions.max_read_len``, the
    narrow bucket) where no read is longer, ``LONG_READ_LEN`` (the wide
    bucket) where a read is longer and no longer than ``LONG_READ_LEN``.
    A read past ``LONG_READ_LEN`` fits no bucket and widens nothing
    (``io/fastq.py`` keeps it with length 0)."""
    lens = np.asarray(lens)
    wide = (lens > max_len) & (lens <= LONG_READ_LEN)
    return LONG_READ_LEN if wide.any() else max_len


def batch_widths(opt, width: int) -> Widths:
    """The device widths of a read batch `width` wide under the options
    `opt`: the bucket ``batch_width`` gives reads of that length."""
    if width > max(opt.max_read_len, LONG_READ_LEN):
        raise ValueError(f"a read batch {width} wide: the port aligns "
                         f"reads of at most {LONG_READ_LEN} bp")
    return NARROW if batch_width(opt.max_read_len, width) == \
        opt.max_read_len else WIDE
