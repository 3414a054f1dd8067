"""End-to-end throughput on one device: ``python -m tpubwa_torch.tools.bench``.

The port of the JAX package's ``bench.py``, with flags in place of its
environment knobs (``TPUBWA_BENCH_READS`` -> ``--reads``, ``_REF_MB`` ->
``--ref-mb``, ``_PE=1`` -> ``--pe``, ``_STYLE`` -> ``--style``,
``_THREADS`` -> ``--threads``, ``_BATCH`` -> ``--batch``, ``_PASSES`` ->
``--passes``):

  python -m tpubwa_torch.tools.bench [--reads 20000] [--ref-mb 4.6] [--pe]
      [--style random|chr21] [--threads 1] [--batch 8192] [--passes 3]
      [--kernel] [--ext-layout t|b] [--device cuda|cpu] [--work DIR]

Its four configurations: SE on a 4.6 Mb random genome (the default), SE
and PE (``--pe``, 10,000 pairs) on a 46 Mb chr21-style genome
(``--ref-mb 46 --style chr21``), and the DP-kernel mode ``--kernel``.

The fixture (``ensure_fixture``) is bench.py's, byte for byte: the genome
(uniform random or ``utils.simgenome.repeat_genome``, seed 42) as
``>benchref`` at 80 columns, its index, and 150 bp reads at 1 % error
(seed 7), built once into ``--work`` under bench.py's file names.  One
``Aligner`` serves the warm-up (the first ``batch + (reads % batch or
batch)`` reads) and every timed pass; a pass is ``run_se_pipeline`` or
``align_pe_fastq`` into a sink that counts and hashes the text.  The value
is reads over the median pass (the fastest of fewer than 3).

The last line of stdout is one JSON record with bench.py's keys
(``metric``, named as bench.py names it, ``value``, ``unit`` and
``vs_baseline``: reads/s over the reference bwa-mem2's 130,378 reads/s, a
16-vCPU Graviton4 figure) and ``passes_s`` (every pass, in run order),
``phases_s`` (the phase timers over the timed passes), ``sam_records``
and ``sam_body_sha256`` (the SAM lines of the last pass; the pipelines
write no header), ``device`` and ``card`` (nvidia-smi's name and power
limit; null on the CPU).  Warm-up, kernel build and index upload go to
stderr, never into a pass.

``--kernel`` times the extension DP alone: ``B`` jobs with query = target
(no job leaves early), ``REP`` calls of the layout's wrapper (K1, or K1b
under ``--ext-layout b``; the plain version on the CPU) back to back
with h0 + i, between two CUDA events, the best of three such runs over
``REP``.  The cells are the band cells the plain version visits on the
same inputs (``ops.extend._extend_core``'s ``stats``), and its scores are
held to the last call's.  ``value`` is visited Gcells/s; ``vs_baseline``
its share of the card's bound, ``INT32_OPS / OPS_EXT_CELL`` cells/s
(``utils.roofline``), null on the CPU.

``--device cuda`` (the default) raises when torch sees no GPU, before
anything is built; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE_READS_PER_SEC = 130_378.0
B, Q, T, REP = 4096, 256, 256, 16      # --kernel: bench.py's shape


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ensure_fixture(ref_mb: float, n_reads: int, pe: bool,
                   style: str = "random",
                   work: str = os.path.join(ROOT, ".bench")
                   ) -> tuple[str, str, str | None]:
    """bench.py's ``_ensure_fixture``: (FASTA, FASTQ 1, FASTQ 2 or None) in
    `work`, each built only when absent; the same names and bytes."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import read_fasta
    from tpubwa_torch.utils import sim
    from tpubwa_torch.utils.dna import decode
    from tpubwa_torch.utils.simgenome import repeat_genome

    if style not in ("random", "chr21"):
        raise ValueError(f"style {style!r}: choose random or chr21")
    os.makedirs(work, exist_ok=True)
    ref_len = int(ref_mb * 1e6)
    tag0 = "" if style == "random" else f"_{style}"
    ref_fa = os.path.join(work, f"ref_{ref_len}{tag0}.fa")
    if not os.path.exists(ref_fa):
        rng = np.random.default_rng(42)
        codes = (repeat_genome(rng, ref_len) if style == "chr21"
                 else rng.integers(0, 4, ref_len).astype(np.uint8))
        seq = decode(codes)
        with open(ref_fa, "w") as f:
            f.write(">benchref\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + "\n")
    if not FMIndex.exists(ref_fa):
        t = time.monotonic()
        FMIndex.from_fasta(ref_fa).save(ref_fa)
        _log(f"[bench] index built in {time.monotonic() - t:.1f}s")

    tag = ("pe" if pe else "se") + tag0
    fq1 = os.path.join(work, f"reads_{ref_len}_{n_reads}_{tag}_1.fq")
    fq2 = os.path.join(work, f"reads_{ref_len}_{n_reads}_{tag}_2.fq")
    if not os.path.exists(fq1):
        contigs, codes, _ = read_fasta(ref_fa)
        if pe:
            r1, r2 = sim.simulate_pairs(codes, contigs, n_reads // 2,
                                        length=150, err=0.01, seed=7)
            sim.write_fastq(fq1, r1)
            sim.write_fastq(fq2, r2)
        else:
            sim.write_fastq(fq1, sim.simulate_reads(
                codes, contigs, n_reads, length=150, err=0.01, seed=7))
    return ref_fa, fq1, (fq2 if pe else None)


class NullOut(io.TextIOBase):
    """SAM sink that still forces the text: counts its lines and keeps a
    running SHA-256 of it."""

    def __init__(self) -> None:
        self.n_records = 0
        self.sha = hashlib.sha256()

    def write(self, s: str) -> int:  # type: ignore[override]
        self.n_records += s.count("\n")
        self.sha.update(s.encode())
        return len(s)


def metric_name(pe: bool, ref_mb: float, style: str) -> str:
    """bench.py's name of the reads/s metric."""
    return ("reads_per_sec_1chip_" + ("pe" if pe else "se")
            + f"_{ref_mb:g}Mb" + ("" if style == "random" else f"_{style}")
            + "_150bp_err1pct")


def _head(src: str, dst: str, n_reads: int) -> None:
    with open(src) as f, open(dst, "w") as w:
        for i, line in enumerate(f):
            if i >= 4 * n_reads:
                break
            w.write(line)


def bench_reads(args, dev: torch.device) -> dict:
    """The end-to-end passes; returns the record."""
    from tpubwa_torch.align.pair import align_pe_fastq
    from tpubwa_torch.align.pipeline import (Aligner, build_kernels,
                                             run_se_pipeline)
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.tools.big import card_line
    from tpubwa_torch.utils.timers import PhaseTimers

    fa, fq1, fq2 = ensure_fixture(args.ref_mb, args.reads, args.pe,
                                  args.style, args.work)
    batch = args.batch
    warm_n = batch + (args.reads % batch or batch)
    warm = [os.path.join(args.work, "warm.fq"), None]
    _head(fq1, warm[0], warm_n)
    if args.pe:
        warm[1] = os.path.join(args.work, "warm2.fq")
        _head(fq2, warm[1], warm_n)

    if dev.type == "cuda":
        t = time.monotonic()
        build_kernels(args.ext_layout)
        _log(f"[bench] kernels built in {time.monotonic() - t:.1f}s")
    t = time.monotonic()
    aligner = Aligner(FMIndex.load(fa), MemOptions(batch_reads=batch),
                      device=dev, ext_layout=args.ext_layout)
    _sync(dev)
    _log(f"[bench] index loaded and put on {dev} in "
         f"{time.monotonic() - t:.1f}s")

    def run_pass(fq_a: str, fq_b: str | None, sink: NullOut) -> float:
        _sync(dev)
        t0 = time.monotonic()
        if fq_b is not None:
            align_pe_fastq(aligner, fq_a, fq_b, sink, workers=args.threads)
        else:
            run_se_pipeline(aligner, fq_a, sink, workers=args.threads)
        _sync(dev)
        return time.monotonic() - t0

    _log(f"[bench] warmup {run_pass(*warm, NullOut()):.1f}s")
    aligner.timers = PhaseTimers()       # the timed passes' phase profile
    times = []
    for _ in range(args.passes):
        sink = NullOut()
        times.append(run_pass(fq1, fq2, sink))
    ranked = sorted(times)
    dt = ranked[len(ranked) // 2] if args.passes >= 3 else ranked[0]
    _log("[bench] pass times: " + " ".join(f"{x:.2f}s" for x in ranked))
    _log(aligner.timers.report())
    rps = args.reads / dt
    _log(f"[bench] {args.reads} reads in {dt:.2f}s -> {rps:.0f} reads/s "
         f"({sink.n_records} SAM lines)")
    return {
        "metric": metric_name(args.pe, args.ref_mb, args.style),
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 4),
        "passes_s": [round(x, 4) for x in times],
        "phases_s": {k: round(v, 4)
                     for k, v in aligner.timers.totals.items()},
        "sam_records": sink.n_records,
        "sam_body_sha256": sink.sha.hexdigest(),
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
    }


def kernel_inputs() -> tuple[tuple, dict]:
    """bench.py's kernel-mode jobs as numpy arrays: (query, qlen, target,
    tlen, mat, w, h0, end_bonus) and the gap keywords; B full-match jobs
    (the target is the query, repeated where T > Q), band opt.w, h0 30,
    end bonus 5."""
    from tpubwa_torch.config import MemOptions

    opt = MemOptions()
    q = np.random.default_rng(0).integers(0, 4, (B, Q)).astype(np.int32)
    args = (q, np.full(B, Q, np.int32), q[:, np.arange(T) % Q],
            np.full(B, T, np.int32),
            np.asarray(opt.score_matrix(), np.int32),
            np.full(B, opt.w, np.int32), np.full(B, 30, np.int32),
            np.full(B, 5, np.int32))
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
    return args, kw


def bench_kernel(dev: torch.device, ext_layout: str = "t") -> tuple:
    """The DP-kernel mode; returns (record, the last call's result)."""
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
    from tpubwa_torch.tools.big import card_line
    from tpubwa_torch.utils.roofline import INT32_OPS, OPS_EXT_CELL

    # extend_core is what ops.extend.extend_batch (bench.py's core) calls
    core = {"t": extend_core, "b": extend_core_b}[ext_layout]
    args, kw = kernel_inputs()
    a = [torch.as_tensor(x, device=dev) for x in args]
    h0s = [a[6] + i for i in range(REP)]
    n0 = core.launches

    def calls():
        for h0 in h0s:
            out = core(*a[:6], h0, a[7], **kw)
        return out

    out = calls()                        # build and warm
    _sync(dev)
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = calls()
            e1.record()
            torch.cuda.synchronize(dev)
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            out = calls()
            best = min(best, time.perf_counter() - t0)
    dt = best / REP
    launches = core.launches - n0
    stats: dict = {}
    want = _extend_core(*a[:6], h0s[-1], a[7], **kw, stats=stats)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(out, want))
    cells = int(stats["cells"])
    rate = cells / dt
    on_card = dev.type == "cuda"
    bound_rate = INT32_OPS / OPS_EXT_CELL
    rec = {
        "metric": f"dp_kernel_cells_per_sec_{dev.type}",
        "value": round(rate / 1e9, 2),
        "unit": (f"Gcells/s (band cells visited; one call of the "
                 f"{core.__name__} wrapper: its prep, sort and kernel "
                 "launches)"),
        "vs_baseline": round(rate / bound_rate, 4) if on_card else None,
        "layout": ext_layout,
        "ms": round(dt * 1e3, 4),
        "cells": cells,
        "hw_cells": B * T * Q,
        "max_abs_err": err,
        "launches": launches,
        "device": str(dev),
        "card": card_line() if on_card else None,
    }
    _log(f"[bench --kernel] {B} jobs x {T} rows x {Q} cols, {REP} calls: "
         f"{dt * 1e3:.3f} ms a call -> {rate / 1e9:.2f} Gcells/s visited "
         f"({cells} of {B * T * Q} cells)"
         + (f", {100 * rate / bound_rate:.1f}% of the bound "
            f"{bound_rate / 1e9:.0f} Gcells/s" if on_card else "")
         + f"; last call vs plain: max |err| {err}")
    return rec, out


def run(argv=None) -> dict:
    """Parse `argv`, run, return the record."""
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.parallel.mesh import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.bench",
        description="Reads/s end to end on one device (bench.py's "
        "workloads), or the DP kernel's cells/s.")
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--ref-mb", type=float, default=4.6)
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--style", choices=("random", "chr21"),
                    default="random")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--batch", type=int, default=MemOptions().batch_reads)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--ext-layout", choices=("t", "b"), default="t")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(ROOT, ".bench"))
    args = ap.parse_args(argv)
    if args.passes < 1:
        ap.error("--passes must be at least 1")
    dev = resolve_device(args.device)      # no GPU: fail before building
    if args.kernel:
        return bench_kernel(dev, args.ext_layout)[0]
    return bench_reads(args, dev)


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
