"""Flat extension driver: chain + extend a whole read batch with native
calls and a few device waves (port of ``tpubwa.align.flatext``).

  seed rows (host)
    -> native ext_prepare   : chain/filter every read + one job descriptor
                              per chain seed
    -> device extend_jobs_* : gather q/t windows on device, band-doubling
                              DP (the extension kernel), one call per wave
                              (on a device mesh, one per device a wave)
    -> native ext_finalize  : sequential containment replay -> regions
"""
from __future__ import annotations

import ctypes

import numpy as np

from tpubwa_torch.align.region import AlnReg, read_regions
from tpubwa_torch.config import MemOptions, batch_widths
from tpubwa_torch.native import load_native
from tpubwa_torch.ops.extend_flat import (T_PAD, extend_jobs,
                                          extend_jobs_left,
                                          extend_jobs_right)
from tpubwa_torch.utils.timers import count

# job lists up to 2 * MIN_WAVE run the whole-seed program in one wave;
# longer lists run separate left and right streams in waves of at most
# MAX_WAVE lanes (wave sizes decide nothing in the output)
MIN_WAVE = 256
MAX_WAVE = 8192


_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def prepare_jobs(opt: MemOptions, l_pac: int, contig_offsets: np.ndarray,
                 seed_rows: np.ndarray, bounds: np.ndarray,
                 skip: np.ndarray, lens: np.ndarray, l_rep: np.ndarray):
    """native ext_prepare.  Returns (handle, jobs-dict, n_jobs)."""
    lib = load_native()
    seed_rows = np.ascontiguousarray(seed_rows, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    skip = np.ascontiguousarray(skip, dtype=np.uint8)
    offs = np.ascontiguousarray(contig_offsets, dtype=np.int64)
    lens = _i32(lens)
    l_rep = _i32(l_rep)
    n_seeds = len(seed_rows)
    n_reads = len(bounds) - 1
    cap = max(n_seeds, 1)
    jobs = {
        "read": np.empty(cap, np.int32),
        "qbeg": np.empty(cap, np.int32),
        "slen": np.empty(cap, np.int32),
        "rbeg": np.empty(cap, np.int64),
        "rmax0": np.empty(cap, np.int64),
        "rmax1": np.empty(cap, np.int64),
        "h0": np.empty(cap, np.int32),
    }
    counts = np.zeros(1, np.int64)
    handle = lib.ext_prepare(
        seed_rows.ctypes.data_as(_I64P), n_seeds,
        bounds.ctypes.data_as(_I64P), n_reads,
        skip.ctypes.data_as(_U8P),
        offs.ctypes.data_as(_I64P), len(offs), l_pac,
        lens.ctypes.data_as(_I32P), l_rep.ctypes.data_as(_I32P),
        opt.w, opt.max_chain_gap, opt.min_chain_weight,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio,
        opt.min_seed_len,
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.pen_clip5, opt.pen_clip3,
        jobs["read"].ctypes.data_as(_I32P),
        jobs["qbeg"].ctypes.data_as(_I32P),
        jobs["slen"].ctypes.data_as(_I32P),
        jobs["rbeg"].ctypes.data_as(_I64P),
        jobs["rmax0"].ctypes.data_as(_I64P),
        jobs["rmax1"].ctypes.data_as(_I64P),
        jobs["h0"].ctypes.data_as(_I32P),
        cap, counts.ctypes.data_as(_I64P))
    if not handle:
        raise RuntimeError("ext_prepare capacity exceeded")
    return handle, jobs, int(counts[0])


def _ext_kw(aligner, codes_on: dict) -> dict:
    """The extension programs' settings; the query window is the
    bucket's of the batch in `codes_on`."""
    opt = aligner.opt
    width = next(iter(codes_on.values()))[0].shape[1]
    return dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a, w0=opt.w,
                q_pad=batch_widths(opt, width).ext_q, core=aligner.ext_core)


def _on_mesh(aligner, codes_on: dict, n: int, fn) -> list:
    """Run ``fn(sl, di, codes, lens, mat, put)`` on each mesh device's
    contiguous part ``sl`` of n lanes (an empty part runs nothing);
    returns [(sl, result)] in lane order, nothing read back yet."""
    out = []
    for d, (lo, hi) in enumerate(aligner.mesh.split(n)):
        if hi > lo:
            dev = aligner.mesh[d]
            codes, lens = codes_on[dev]
            out.append((slice(lo, hi), fn(
                slice(lo, hi), aligner.index_on(dev)[0], codes, lens,
                aligner.mat_on(dev),
                lambda a, dev=dev: aligner._put(a, dev))))
    return out


def run_waves(aligner, codes_dev, lens_dev, jobs: dict, n_jobs: int,
              lens_host: np.ndarray, codes_on: dict | None = None
              ) -> np.ndarray:
    """Run the extension programs over the job list; returns int32
    [n_jobs, 14] results in job order.

    The LEFT and RIGHT halves run as separate wave streams, each sorted by
    its own effective depth (~min(tlen, qlen + w)), so a wave holds lanes
    of similar depth.  The right stream seeds from the left stream's
    score0 (bwa's mem_chain2aln order).

    On a device mesh each wave's lanes are split into contiguous parts,
    one a device, joined again in lane order (a job's result depends on
    neither its wave nor its part).  ``codes_on`` holds the batch on each
    distinct device (``Aligner.batch_on``; copied from ``codes_dev`` when
    absent)."""
    if codes_on is None:
        codes_on = aligner.batch_on(codes_dev, lens_dev)
    if n_jobs <= 2 * MIN_WAVE:
        return _run_waves_fused(aligner, codes_on, jobs, n_jobs)

    opt = aligner.opt
    w0 = opt.w
    kw = _ext_kw(aligner, codes_on)
    q_pad = kw["q_pad"]
    jb = {k: v[:n_jobs] for k, v in jobs.items()}
    qb = jb["qbeg"].astype(np.int64)
    sl = jb["slen"].astype(np.int64)
    d_l = np.minimum(jb["rbeg"] - jb["rmax0"], T_PAD)
    d_r = np.minimum(jb["rmax1"] - jb["rbeg"] - sl, T_PAD)
    q_l = np.minimum(qb, q_pad)
    q_r = np.minimum(np.asarray(lens_host)[jb["read"]] - qb - sl, q_pad)
    ord_l = np.argsort(np.minimum(d_l, q_l + w0 + 1), kind="stable")
    ord_r = np.argsort(np.minimum(d_r, q_r + w0 + 1), kind="stable")

    def waves_of(order, fields, fn):
        """fn over waves of the permuted job list -> [(rows, [k, take])]"""
        res = []
        for j0 in range(0, n_jobs, MAX_WAVE):
            rows = order[j0:j0 + MAX_WAVE]
            res += [(rows[sl], r) for sl, r in _on_mesh(
                aligner, codes_on, rows.size,
                lambda sl, di, codes, lens, mat, put, rows=rows: fn(
                    di, codes, lens, [put(f[rows[sl]]) for f in fields],
                    mat))]
        return [(rows, r.cpu().numpy()) for rows, r in res]

    left8 = np.empty((n_jobs, 8), np.int32)
    for rows, r in waves_of(
            ord_l, [jb["read"], jb["qbeg"], jb["rbeg"], jb["rmax0"],
                    jb["h0"]],
            lambda di, codes, lens, a, mat: extend_jobs_left(
                di, codes, lens, *a, mat, pen_clip5=opt.pen_clip5, **kw)):
        left8[rows] = r.T
    score0 = left8[:, 7].copy()

    out = np.empty((n_jobs, 14), np.int32)
    out[:, 0:6] = left8[:, 0:6]
    out[:, 12] = left8[:, 6]              # aw0
    for rows, r in waves_of(
            ord_r, [jb["read"], jb["qbeg"], jb["slen"], jb["rbeg"],
                    jb["rmax1"], score0],
            lambda di, codes, lens, a, mat: extend_jobs_right(
                di, codes, lens, *a, mat, pen_clip3=opt.pen_clip3, **kw)):
        out[rows, 6:12] = r.T[:, 0:6]
        out[rows, 13] = r.T[:, 6]         # aw1
    return out


def _run_waves_fused(aligner, codes_on: dict, jobs: dict,
                     n_jobs: int) -> np.ndarray:
    """Whole-seed extension (both halves in one program) per wave, for
    short job lists."""
    opt = aligner.opt
    kw = _ext_kw(aligner, codes_on)
    out = np.empty((max(n_jobs, 1), 14), np.int32)
    for j0 in range(0, n_jobs, MAX_WAVE):
        wave = {k: jobs[k][j0:min(j0 + MAX_WAVE, n_jobs)]
                for k in ("read", "qbeg", "slen", "rbeg", "rmax0", "rmax1",
                          "h0")}
        parts = _on_mesh(
            aligner, codes_on, wave["read"].size,
            lambda sl, di, codes, lens, mat, put: extend_jobs(
                di, codes, lens, *(put(v[sl]) for v in wave.values()), mat,
                pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3, **kw))
        for sl, res in parts:
            out[j0 + sl.start:j0 + sl.stop] = res.cpu().numpy().T
    return out


def finalize_fields(handle, results: np.ndarray, n_reads: int,
                    n_jobs: int) -> tuple[dict, np.ndarray]:
    """native ext_finalize: containment replay -> flat per-region arrays
    (fields dict + bounds[n_reads+1]) — the flat SAM path consumes these
    directly (align/flatsam.py); finalize_regs wraps them into AlnReg
    lists for the generator path."""
    lib = load_native()
    results = np.ascontiguousarray(results, dtype=np.int32)
    cap = max(n_jobs, 1)
    fields: dict = {"rb": np.empty(cap, np.int64),
                    "re": np.empty(cap, np.int64)}
    for k in ("qb", "qe", "score", "truesc", "w", "seedcov", "rid",
              "seedlen0"):
        fields[k] = np.empty(cap, np.int32)
    fields["frac_rep"] = np.empty(cap, np.float64)
    bounds = np.empty(n_reads + 1, np.int64)
    counts = np.zeros(1, np.int64)
    rc = lib.ext_finalize(
        handle, results.ctypes.data_as(_I32P),
        fields["rb"].ctypes.data_as(_I64P),
        fields["re"].ctypes.data_as(_I64P),
        fields["qb"].ctypes.data_as(_I32P),
        fields["qe"].ctypes.data_as(_I32P),
        fields["score"].ctypes.data_as(_I32P),
        fields["truesc"].ctypes.data_as(_I32P),
        fields["w"].ctypes.data_as(_I32P),
        fields["seedcov"].ctypes.data_as(_I32P),
        fields["rid"].ctypes.data_as(_I32P),
        fields["seedlen0"].ctypes.data_as(_I32P),
        fields["frac_rep"].ctypes.data_as(_F64P),
        bounds.ctypes.data_as(_I64P), cap, counts.ctypes.data_as(_I64P))
    if rc != 0:
        raise RuntimeError("ext_finalize capacity exceeded")
    return fields, bounds


def finalize_regs(handle, results: np.ndarray, n_reads: int,
                  n_jobs: int) -> list[list[AlnReg]]:
    """native ext_finalize: containment replay -> list[list[AlnReg]]."""
    fields, bounds = finalize_fields(handle, results, n_reads, n_jobs)
    return [read_regions(fields, bounds, r) for r in range(n_reads)]


def run_phased(aligner, codes_dev, lens_dev, handle, jobs: dict,
               n_jobs: int, lens_host: np.ndarray,
               codes_on: dict | None = None) -> np.ndarray:
    """Phased extension rounds — bwa's sequential seed-skip recovered for
    batched device waves.

    Round 1 runs the first-visited seed of every chain (native
    ext_phase1); the native replay (ext_missing) then re-walks the reads
    with the results so far and returns exactly the jobs a further round
    must run; ext_finalize's sequential replay never reads a slot that was
    not run.  Output is identical to running every job.  ``codes_on`` is
    ``run_waves``'s, made once here when absent.  Counts the call
    (``bsw.calls``) and its rounds (``bsw.rounds``) in the Aligner's
    timers."""
    lib = load_native()
    if codes_on is None:
        codes_on = aligner.batch_on(codes_dev, lens_dev)

    results = np.zeros((max(n_jobs, 1), 14), np.int32)
    have = np.zeros(max(n_jobs, 1), np.uint8)
    ids = np.empty(max(n_jobs, 1), np.int64)
    n1 = lib.ext_phase1(handle, ids.ctypes.data_as(_I64P))
    run = ids[:n1].copy()
    count(aligner.timers, "bsw.calls")
    while run.size:
        count(aligner.timers, "bsw.rounds")
        sub = {k: np.ascontiguousarray(v[:n_jobs][run])
               for k, v in jobs.items()}
        results[run] = run_waves(aligner, codes_dev, lens_dev, sub, run.size,
                                 lens_host=lens_host, codes_on=codes_on)
        have[run] = 1
        n_miss = lib.ext_missing(
            handle, results.ctypes.data_as(_I32P), have.ctypes.data_as(_U8P),
            ids.ctypes.data_as(_I64P), len(ids))
        if n_miss < 0:
            raise RuntimeError("ext_missing capacity exceeded")
        run = ids[:n_miss].copy()
    return results
