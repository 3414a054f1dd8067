"""Build and load the port's native host library.

The C++ sources in this directory (SA-IS index construction, seed
chaining (``chain.cpp``), the extension replay, SAM assembly, the flat
tier's SE and PE selection (``flatsel.cpp``), mate rescue's rounds
(``rescue.cpp``); ``core.h``
holds what chaining and the replay share) compile into one shared
library with a plain C interface, loaded via ctypes.  ``load_native``
compiles them with g++ (``GXX``) at first use into ``build/tpubwa_torch/``,
keyed by a hash of the sources, as ``ops.cuda_build`` does for the CUDA
kernels.  There is no fallback: a missing g++ or a failed build raises
with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from tpubwa_torch.ops.cuda_build import BUILD_DIR, lock

_DIR = Path(__file__).resolve().parent
GXX = "g++"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib = None


def as_ptr(a):
    """A ctypes pointer to a contiguous int64, int32, uint32, uint8 or
    float64 numpy array's data (the caller keeps the array alive)."""
    c = ctypes
    return a.ctypes.data_as(c.POINTER(
        {"int64": c.c_int64, "int32": c.c_int32, "uint32": c.c_uint32,
         "uint8": c.c_uint8, "float64": c.c_double}[a.dtype.name]))


def _sources() -> list[Path]:
    return sorted(_DIR.glob("*.cpp"))


def load_native() -> ctypes.CDLL:
    """Build (unless a build of these exact sources exists) and load the
    native library.  Raises RuntimeError when g++ is missing or fails."""
    global _lib
    with lock("native"):
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256()
        for p in [*srcs, *sorted(_DIR.glob("*.h"))]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        so = BUILD_DIR / f"libtpubwa_native_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique per process and thread: other processes may build the
            # same sources into the same directory at the same time
            tmp = so.with_name(
                f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [GXX, *GXX_FLAGS, "-o", str(tmp), *map(str, srcs)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"{GXX} not found; the native host library must be "
                    f"built from {_DIR}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{GXX} failed on {_DIR}/*.cpp:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib) -> None:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)

    lib.sais_u8.restype = c.c_int
    lib.sais_u8.argtypes = [u8p, i64p, c.c_int64, c.c_int64]

    lib.bwt_from_sa.restype = c.c_int
    lib.bwt_from_sa.argtypes = [u8p, i64p, c.c_int64, u8p, i64p]

    lib.chain_filter_batch.restype = c.c_int
    lib.chain_filter_batch.argtypes = [
        i64p, c.c_int64,          # seed_rows, n_seeds
        i64p, c.c_int64,          # read_bounds, n_reads
        u8p,                      # skip_read
        i64p, c.c_int64, c.c_int64,   # contig_offsets, n_contigs, l_pac
        c.c_int32, c.c_int32, c.c_int32, c.c_int64,  # w, gap, minw, maxext
        c.c_double, c.c_double, c.c_int32,  # mask_level, drop_ratio, minseed
        i32p, i32p, i32p, i64p, i64p, c.c_int64,  # outputs + cap
        i64p,                     # out_counts
    ]

    f64p = c.POINTER(c.c_double)
    lib.ext_prepare.restype = c.c_void_p
    lib.ext_prepare.argtypes = [
        i64p, c.c_int64,          # seed_rows, n_seeds
        i64p, c.c_int64,          # read_bounds, n_reads
        u8p,                      # skip_read
        i64p, c.c_int64, c.c_int64,   # contig_offsets, n_contigs, l_pac
        i32p, i32p,               # lens, l_rep
        c.c_int32, c.c_int32, c.c_int32, c.c_int64,  # w, gap, minw, maxext
        c.c_double, c.c_double, c.c_int32,  # mask_level, drop_ratio, minseed
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,  # a, gaps
        c.c_int32, c.c_int32,     # pen_clip5, pen_clip3
        i32p, i32p, i32p, i64p, i64p, i64p, i32p,  # job outputs
        c.c_int64, i64p,          # cap, out_counts
    ]
    lib.ext_finalize.restype = c.c_int
    lib.ext_finalize.argtypes = [
        c.c_void_p, i32p,         # handle, results [n_jobs, 14]
        i64p, i64p,               # reg_rb, reg_re
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # int32 reg fields
        f64p,                     # reg_frac_rep
        i64p, c.c_int64, i64p,    # reg_bounds, cap, out_counts
    ]
    lib.ext_free.restype = None
    lib.ext_free.argtypes = [c.c_void_p]

    lib.ext_phase1.restype = c.c_int64
    lib.ext_phase1.argtypes = [c.c_void_p, i64p]

    lib.ext_missing.restype = c.c_int64
    lib.ext_missing.argtypes = [c.c_void_p, i32p, u8p, i64p, c.c_int64]

    i8p = c.POINTER(c.c_int8)
    lib.sam_emit_se.restype = c.c_int64
    lib.sam_emit_se.argtypes = [
        c.c_int64,                      # B
        u8p, i64p,                      # other, other_off
        u8p, i64p, u8p, i64p, u8p, i64p,  # name/seq/qual bufs+offs
        u8p, i64p,                      # cname buf+off
        c.c_int64,                      # NL lanes
        u8p, i32p, i64p,                # rev, rid, pos1
        i32p, i32p,                     # clip5, clip3
        i32p, i32p, c.c_int64,          # cig_ns, cig_pack, ga_k
        i32p, i32p,                     # lead_d, trail_d
        i32p, u8p, u8p, c.c_int64,      # nm_in, mm_pos, mm_let, mm_k
        i32p, i32p,                     # lq, rlen
        i32p, i8p, i8p, c.c_int64, c.c_int64,  # win_row, qwin, twin, dims
        c.c_int64,                      # NR records
        i32p, i32p,                     # rec_b, rec_lane
        i32p, i32p, i32p, i32p,         # flag, mapq, score, xs
        i32p, i64p, i64p,               # rnext_rid, pnext, tlen
        i32p, i32p,                     # alt_lo, alt_hi
        u8p, c.c_int64,                 # out, out_cap
    ]

    lib.pe_select_flat.restype = c.c_int64
    lib.pe_select_flat.argtypes = [
        c.c_int64, i64p,                # B pairs, bounds [2B + 1]
        i64p, i64p, i64p, i64p,         # rb, re, qb, qe
        i64p, i64p, i64p,               # rid, score, sub_n
        i64p, c.c_int64, c.c_int64,     # contig_off, n_contigs, l_pac
        c.c_double, c.c_int64,          # mask_level, tmp
        c.c_int64, c.c_int64,           # T, pen_unpaired
        c.c_double, c.c_int64,          # XA_drop_ratio, max_XA_hits
        c.c_int64, c.c_int64,           # sam_q, sam_t
        u8p, i64p, i64p,                # pe failed, low, high
        i64p, f64p, c.c_int64,          # tab_off, tab, pair_id0
        i64p, i32p, i64p, i64p,         # order, sec, sub, sub_n
        u8p, i64p, i64p, i64p,          # flat, o, subo, n_sub
        u8p, i64p, i64p,                # proper, z, pick
        i64p, i64p, i64p, i64p,         # sub_eff, subn_eff, alt_cnt, alts
    ]

    lib.se_select_flat.restype = c.c_int64
    lib.se_select_flat.argtypes = [
        c.c_int64, i64p,                # B reads, bounds [B + 1]
        i64p, i64p, i64p, i64p,         # rb, re, qb, qe
        i64p, i64p,                     # rid, score
        c.c_int64, c.c_double,          # l_pac, mask_level
        c.c_int64, c.c_int64,           # tmp, T
        c.c_double, c.c_int64,          # XA_drop_ratio, max_XA_hits
        c.c_int64,                      # max_chain_gap
        c.c_int64, c.c_int64,           # sam_q, sam_t
        c.c_int64,                      # read_id0
        u8p, i64p, i64p, i64p,          # tier, prim, sub, sub_n
        i64p, i64p,                     # alt_cnt, alt_rows
    ]

    u32p = c.POINTER(c.c_uint32)
    lib.pe_rescue_round1.restype = c.c_int64
    lib.pe_rescue_round1.argtypes = [
        c.c_int64, i64p,                # B pairs, bounds [2B + 1]
        i64p, i64p, i64p,               # rb, rid, score
        u8p, i64p, i64p,                # pe failed, low, high
        i64p, i64p, c.c_int64,          # contig_off, contig_len, n_contigs
        c.c_int64, u32p,                # l_pac, pac
        u8p, i64p, u8p, i64p,           # codes0, lens0, codes1, lens1
        c.c_int64,                      # width
        c.c_int64, c.c_int64,           # pen_unpaired, max_matesw
        c.c_int64, c.c_int64,           # min_seed_len, minsc
        c.c_int64, c.c_int64, c.c_int64,  # q_pad, t_pad, cap
        i32p, i64p, i64p, u8p, i64p,    # buf, anchor, rb, rev, lms
        i64p,                           # out [3]
    ]
    lib.pe_rescue_round2.restype = c.c_int64
    lib.pe_rescue_round2.argtypes = [
        c.c_int64, i32p,                # J, buf1
        c.c_int64, c.c_int64,           # q_pad, t_b1
        i64p, c.c_int64, c.c_int64,     # res [4, J], min_seed_len, t_pad
        i32p, i64p, i64p,               # buf2, hits, out [1]
    ]
