"""Where one SE batch's time goes: ``python -m tpubwa_torch.tools.profile_se``.

The port of the JAX package's ``scripts/profile_r4.py``: the flat SE path
split into its stages, on bench.py's SE fixture (``tools.bench
.ensure_fixture(--ref-mb, 20000, False, --style)``).  It warms on batch 0
and profiles batch 1 (read ids from 0, as the script does):

  python -m tpubwa_torch.tools.profile_se [--ref-mb 4.6]
      [--style random|chr21] [--device cuda|cpu] [--work DIR]

Seeding, each stage alone, the best of 3 (host clock between two
``torch.cuda.synchronize``; every stage is several launches):

* ``r1_prep``: ``ops.smem_chain._smem_r1_prep`` (K2 round 1, append,
  round-2 candidate table);
* ``r2_loop``: ``_smem_r2_loop`` (K2 round 2 in waves);
* ``r3_sort``: K2 round 3 (``smem_chain_cuda.smem_round3_core``), then
  ``_r3_append`` and ``_sort_by_start_end``, the three calls that stand
  for the script's ``_smem_r3_sort``;
* ``seed_rows``: ``ops.seeds.seed_rows`` (the script's "expand").

Then the batch once as the aligner runs it: ``seed_batch_dispatch``
(which waits for round 1's candidate count), the device wait and
``seed_batch_finish`` (the download); native ``flatext.prepare_jobs``;
the extension waves (``flatext.run_phased``, as ``Aligner._regions_flat``
runs them; each round calls ``run_waves``); native ``finalize_fields``;
flat SAM (``flatsam.se_text_batch``).  Inside flat SAM: the device
windows of the primaries of the reads the flat tier takes
(``flatsam.select_se``; best of 3) and their download, and K3's time
(``flatsam._ga_rows`` wrapped, synchronised on both sides) in a second
flat SAM; the host time left is what remains.
Both flat SAM texts must equal ``Aligner.align_se_text(batch, 0)``, or
the tool raises.

Prints the script's lines, then one JSON record: ``stages_ms`` and the
counts beside them.  ``--device cuda`` (the default) raises when torch
sees no GPU; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpubwa_torch.tools.bench import ROOT, _sync, ensure_fixture

N_READS, BATCH_READS = 20_000, 8192     # the script's fixture and batch


def profile(ref_mb: float, style: str, device,
            work: str = os.path.join(ROOT, ".bench")) -> tuple[dict, str]:
    """Returns (the record, the batch's SAM text)."""
    from tpubwa_torch.align import flatext, flatsam
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import batch_widths
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fastq import stream_batches
    from tpubwa_torch.ops.seeds import seed_rows
    from tpubwa_torch.ops.smem_chain import (_r3_append, _smem_r1_prep,
                                             _smem_r2_loop,
                                             _sort_by_start_end)
    from tpubwa_torch.ops.smem_chain_cuda import smem_round3_core
    from tpubwa_torch.parallel.mesh import resolve_device
    from tpubwa_torch.tools.big import card_line

    dev = resolve_device(device)
    fa, fq, _ = ensure_fixture(ref_mb, N_READS, False, style, work)
    idx = FMIndex.load(fa)
    opt = MemOptions(batch_reads=BATCH_READS)
    al = Aligner(idx, opt, device=dev)
    it = stream_batches(fq, opt.batch_reads, opt.max_read_len)
    warm, batch = next(it), next(it)
    wd = batch_widths(opt, batch.codes.shape[1])     # the batch's bucket

    t = time.monotonic()
    al.align_se_text(warm, 0)
    print(f"warmup {time.monotonic() - t:.1f}s")
    n = batch.n
    print(f"== profiling batch of {n} reads ==")
    ms: dict = {}

    def timeit(label, fn, reps=3):
        out = fn()
        _sync(dev)
        best = float("inf")
        for _ in range(reps):
            t0 = time.monotonic()
            out = fn()
            _sync(dev)
            best = min(best, time.monotonic() - t0)
        print(f"  {label:24s} {best * 1e3:8.1f} ms")
        ms[label] = best * 1e3
        return out

    # ---- seeding, stage by stage ----
    q = al._put(np.asarray(batch.codes, np.int32))
    lens = al._put(np.asarray(batch.lens, np.int32))
    cap = opt.max_smems_per_read * wd.seed_scale
    r1 = timeit("r1_prep", lambda: _smem_r1_prep(
        al.di, q, lens, min_seed_len=opt.min_seed_len,
        split_len=opt.split_len, split_width=opt.split_width, out_cap=cap))
    total = int(r1[5])
    mems2 = timeit("r2_loop", lambda: _smem_r2_loop(
        al.di, q, lens, *r1[:5], total, min_seed_len=opt.min_seed_len,
        r2_cap=32, out_cap=cap, G=2 * q.shape[0]))
    sm = timeit("r3_sort", lambda: _sort_by_start_end(_r3_append(
        mems2, smem_round3_core(al.di, q, lens,
                                min_seed_len=opt.min_seed_len,
                                max_mem_intv=opt.max_mem_intv, cap=cap),
        cap), q.shape[1], cap))
    timeit("seed_rows", lambda: seed_rows(
        al.di, sm, max_occ=opt.max_occ,
        per_read_cap=opt.max_seeds_per_read * wd.seed_scale,
        rows_per_read=wd.seed_rows))

    # ---- the batch as the aligner runs it ----
    _sync(dev)
    t0 = time.monotonic()
    handle = al.seed_batch_dispatch(batch.codes, batch.lens)
    ms["dispatch"] = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    _sync(dev)
    ms["device_wait"] = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    rows, l_rep = al.seed_batch_finish(handle)
    ms["finish_download"] = (time.monotonic() - t0) * 1e3
    print(f"  dispatch {ms['dispatch']:.0f}ms  device-wait "
          f"{ms['device_wait']:.0f}ms  finish/download "
          f"{ms['finish_download']:.0f}ms  ({len(rows)} seed rows, "
          f"{rows.nbytes} B)")

    B = batch.n
    t0 = time.monotonic()
    bounds = np.searchsorted(rows[:, 0], np.arange(B + 1))
    skip = (np.asarray(batch.lens) < opt.min_seed_len).astype(np.uint8)
    handle2, jobs, n_jobs = flatext.prepare_jobs(
        opt, idx.l_pac, al.contig_offsets, rows, bounds, skip, batch.lens,
        l_rep[:B])
    ms["ext_prepare"] = (time.monotonic() - t0) * 1e3
    print(f"  ext_prepare {ms['ext_prepare']:.0f}ms  ({n_jobs} jobs)")

    codes_dev, lens_dev = handle.codes_dev, handle.lens_dev
    t0 = time.monotonic()
    results = flatext.run_phased(al, codes_dev, lens_dev, handle2, jobs,
                                 n_jobs, lens_host=batch.lens,
                                 codes_on=handle.codes_on)
    ms["waves"] = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    fields, fbounds = flatext.finalize_fields(handle2, results, B, n_jobs)
    ms["ext_finalize"] = (time.monotonic() - t0) * 1e3
    print(f"  waves {ms['waves']:.0f}ms   ext_finalize "
          f"{ms['ext_finalize']:.0f}ms")

    t0 = time.monotonic()
    text = flatsam.se_text_batch(al, batch, 0, fields, fbounds,
                                 codes_dev=codes_dev)
    ms["flatsam"] = (time.monotonic() - t0) * 1e3
    print(f"  flatsam {ms['flatsam']:.0f}ms  ({len(text)} bytes)")

    # ---- inside flat SAM: the flat tier's windows, K3, the host ----
    sel = flatsam.select_se(opt, fields, fbounds, 0, idx.l_pac, wd)
    flat_rows = np.flatnonzero(sel["tier"] == flatsam.FLAT)
    N = flat_rows.size
    print(f"  [flat classification: {N} flat, {B - N} generator/unmapped]")
    jf = sel["prim"][flat_rows]
    rb = fields["rb"][jf].astype(np.int64)
    qb = fields["qb"][jf].astype(np.int64)
    lq = fields["qe"][jf].astype(np.int64) - qb
    rlen = fields["re"][jf].astype(np.int64) - rb
    ms["flat_windows"] = ms["windows_download"] = 0.0
    if N:
        put = al._put
        win = timeit("flat_windows", lambda: flatsam._flat_windows(
            al.di, codes_dev, put(flat_rows.astype(np.int64)),
            put(qb.astype(np.int32)), put(lq.astype(np.int32)), put(rb),
            put(rlen.astype(np.int32)), put(rb >= idx.l_pac),
            q_pad=wd.sam_q, t_win=wd.sam_t, a=opt.a, b=opt.b),
            reps=3)
        t0 = time.monotonic()
        pk = win[2].cpu()
        ms["windows_download"] = (time.monotonic() - t0) * 1e3
        print(f"  windows download {ms['windows_download']:.0f}ms "
              f"({pk.numel() * pk.element_size()} B)")

    acc = {"ga": 0.0, "calls": 0, "lanes": 0}
    real_ga = flatsam._ga_rows

    def timed_ga(*a, **k):
        _sync(dev)
        t1 = time.monotonic()
        out = real_ga(*a, **k)
        _sync(dev)
        acc["ga"] += time.monotonic() - t1
        acc["calls"] += 1
        acc["lanes"] += a[2].shape[0]
        return out

    flatsam._ga_rows = timed_ga
    try:
        t0 = time.monotonic()
        text2 = flatsam.se_text_batch(al, batch, 0, fields, fbounds,
                                      codes_dev=codes_dev)
        ms["flatsam_again"] = (time.monotonic() - t0) * 1e3
    finally:
        flatsam._ga_rows = real_ga
    ms["ga"] = acc["ga"] * 1e3
    ms["residual_host"] = (ms["flatsam_again"] - ms["ga"]
                           - ms["flat_windows"] - ms["windows_download"])
    print(f"  flatsam again {ms['flatsam_again']:.0f}ms: GA dev "
          f"{ms['ga']:.0f}ms ({acc['calls']} calls, {acc['lanes']} lanes); "
          f"residual host ~{ms['residual_host']:.0f}ms")

    want = al.align_se_text(batch, 0)
    if text != want or text2 != want:
        raise RuntimeError("profile_se: the replayed batch's SAM text is "
                           "not Aligner.align_se_text's")
    total = sum(ms[k] for k in ("dispatch", "device_wait", "finish_download",
                                "ext_prepare", "waves", "ext_finalize",
                                "flatsam")) / 1e3
    seed = sum(ms[k] for k in ("r1_prep", "r2_loop", "r3_sort",
                               "seed_rows"))
    print(f"TOTAL (serial, dispatch included: it waits for round 1) "
          f"{total:.2f}s -> {n / total:.0f} reads/s single-stream")
    print(f"  device share: seed {seed:.1f} ms  (r1 "
          f"{ms['r1_prep']:.1f} r2 {ms['r2_loop']:.1f} r3 "
          f"{ms['r3_sort']:.1f} exp {ms['seed_rows']:.1f})")
    rec = {
        "tool": "profile_se", "ref_mb": ref_mb, "style": style, "reads": n,
        "stages_ms": {k: round(v, 3) for k, v in ms.items()},
        "total_serial_s": round(total, 4),
        "reads_per_sec_serial": round(n / total, 1),
        "seed_rows": int(len(rows)), "n_jobs": int(n_jobs),
        "flat_lanes": int(N), "ga_calls": acc["calls"],
        "ga_lanes": acc["lanes"], "text_bytes": len(text),
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
    }
    return rec, text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.profile_se",
        description="Split one SE batch of the flat path into its stages.")
    ap.add_argument("--ref-mb", type=float, default=4.6)
    ap.add_argument("--style", choices=("random", "chr21"),
                    default="random")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(ROOT, ".bench"))
    args = ap.parse_args(argv)
    rec, _ = profile(args.ref_mb, args.style, args.device, args.work)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
