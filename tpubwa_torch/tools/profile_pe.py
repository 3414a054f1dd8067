"""cProfile of one PE batch: ``python -m tpubwa_torch.tools.profile_pe``.

The port of the JAX package's ``scripts/profile_pe_r5.py`` ("where does
the PAIR phase go?"), on bench.py's PE chr21-style fixture
(``tools.bench.ensure_fixture(--ref-mb, 20000, True, "chr21")``, 10,000
pairs):

  python -m tpubwa_torch.tools.profile_pe [--ref-mb 46] [--top 35]
      [--device cuda|cpu] [--work DIR]

The first batch of each end goes through ``align.pair.align_pe_batch``
three times: once as the streaming driver calls it (both ends' seeding
dispatched first; the warm-up, and the text the others must equal), once
timed with fresh phase timers, and once under cProfile, whose table
(``sort_stats("cumulative")``, the top ``--top`` entries) is printed.
cProfile sees the host: a kernel launch returns at once, and its device
time lands in whatever synchronises next.  The cumulative times of the
Python functions are not moved by that.

The last line is one JSON record: the warm batch's seconds and phases,
the profiled batch's seconds, and the cumulative seconds of the five
functions of ``align/pair.py`` that the PAIR and SAM phases are made of
(``H1_FUNCS``), with their shares of the profiled batch.  ``--device
cuda`` (the default) raises when torch sees no GPU; it never falls back
to the CPU.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

from tpubwa_torch.tools.bench import ROOT, _sync, ensure_fixture

N_READS, BATCH_READS = 20_000, 8192     # the script's fixture and batch
H1_FUNCS = ("pestat", "rescue_batch", "mem_pair", "pe_sam_text",
            "_pe_generator_text")


def h1_times(st: pstats.Stats) -> dict:
    """Cumulative seconds of each of H1_FUNCS (0.0 where not called)."""
    suffix = os.path.join("align", "pair.py")
    out = dict.fromkeys(H1_FUNCS, 0.0)
    for (path, _line, name), (_cc, _nc, _tt, ct, _callers) in \
            st.stats.items():
        if name in out and path.endswith(suffix):
            out[name] += ct
    return out


def profile(ref_mb: float, device, top: int = 35,
            work: str = os.path.join(ROOT, ".bench")) -> tuple[dict, str]:
    """Returns (the record, the profiled batch's SAM text)."""
    from tpubwa_torch.align.pair import align_pe_batch, same_width
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fastq import stream_batches
    from tpubwa_torch.parallel.mesh import resolve_device
    from tpubwa_torch.tools.big import card_line
    from tpubwa_torch.utils.timers import PhaseTimers

    dev = resolve_device(device)
    fa, fq1, fq2 = ensure_fixture(ref_mb, N_READS, True, "chr21", work)
    opt = MemOptions(batch_reads=BATCH_READS)
    al = Aligner(FMIndex.load(fa), opt, device=dev)
    b1, b2 = same_width(*(next(stream_batches(
        fq, opt.batch_reads, opt.max_read_len))
        for fq in (fq1, fq2)))

    handles = (al.seed_batch_dispatch(b1.codes, b1.lens),
               al.seed_batch_dispatch(b2.codes, b2.lens))
    want = align_pe_batch(al, b1, b2, 0, handles=handles)     # the warm-up
    al.timers = PhaseTimers()
    _sync(dev)
    t0 = time.monotonic()
    warm = align_pe_batch(al, b1, b2, 0)
    _sync(dev)
    warm_s = time.monotonic() - t0
    print(f"warm batch: {warm_s:.2f}s", flush=True)
    phases = {k: round(v, 4) for k, v in al.timers.totals.items()}

    pr = cProfile.Profile()
    t0 = time.monotonic()
    pr.enable()
    text = align_pe_batch(al, b1, b2, 0)
    _sync(dev)
    pr.disable()
    prof_s = time.monotonic() - t0
    st = pstats.Stats(pr, stream=sys.stdout)
    st.sort_stats("cumulative").print_stats(top)
    print("(cProfile times the host: a kernel launch returns at once and "
          "its device time shows in whatever synchronises next)")
    if warm != want or text != want:
        raise RuntimeError("profile_pe: the batch's SAM text differs "
                           "between the driver's call and the profiled one")
    cum = h1_times(st)
    rec = {
        "tool": "profile_pe", "ref_mb": ref_mb, "pairs": b1.n,
        "warm_batch_s": round(warm_s, 4), "phases_s": phases,
        "profiled_batch_s": round(prof_s, 4),
        "h1_cum_s": {k: round(v, 4) for k, v in cum.items()},
        "h1_share": {k: round(v / prof_s, 4) for k, v in cum.items()},
        "text_bytes": len(text), "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
    }
    return rec, text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.profile_pe",
        description="cProfile one PE batch of the chr21-style fixture.")
    ap.add_argument("--ref-mb", type=float, default=46)
    ap.add_argument("--top", type=int, default=35)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(ROOT, ".bench"))
    args = ap.parse_args(argv)
    rec, _ = profile(args.ref_mb, args.device, args.top, args.work)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
