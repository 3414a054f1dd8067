#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpubwa_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit; build the extension kernel
   (nvcc, sm_90a) and the native host library, with their build times.
2. Hold the kernel against its plain PyTorch version on the card, exact on
   all six fields: random jobs at J=8192, Q=192, T=768, and the real left
   and right core inputs captured from the first batch of phase 4.
3. The golden fixture of tests/test_golden_sam.py through the port on the
   card must equal tests/golden/se.sam byte for byte.
4. A 4.6 Mb random genome (seed 42), 20,000 x 150 bp reads at 1% error
   (seed 7), batch 8192: one primary per read, >= 97% mapped, >= 92%
   within 50 bp of the simulated position.  The launch counts of this run
   show the main path went through the kernel; a second, warm pass gives
   reads/s and the phase table.

The last two lines are JSON: the kernels (launches, agreement, times) and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

KERNEL_SRC = "tpubwa_torch/csrc/extend.cu"
KERNEL_REPLACES = "tpubwa/ops/extend_pallas.py:211"   # _kernel_t
J_RAND, Q_RAND, T_RAND = 8192, 192, 768
REF_LEN, N_READS, BATCH = 4_600_000, 20_000, 8192


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- 1 ----

def phase_build() -> None:
    from tpubwa_torch.align.flatext import native_lib
    from tpubwa_torch.ops import extend_cuda

    t = time.monotonic()
    report = extend_cuda.build()
    print(f"[build] extension kernel ({KERNEL_SRC}) built and loaded in "
          f"{time.monotonic() - t:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   ptxas: {line.strip()}")
    t = time.monotonic()
    native_lib()
    print(f"[build] native host library ready in "
          f"{time.monotonic() - t:.2f} s")


# ---------------------------------------------------------------- 2 ----

def random_jobs(seed: int, J: int, Q: int, T: int) -> tuple:
    """Extension jobs shaped like the main path's: the query is a mutated
    piece of the target (so bands, gaps and z-drops all occur), with
    empty lanes, N codes and a spread of bands and h0."""
    from tpubwa.config import MemOptions

    rng = np.random.default_rng(seed)
    opt = MemOptions()
    target = rng.integers(0, 4, (J, T)).astype(np.int32)
    query = np.empty((J, Q), np.int32)
    for r in range(J):
        off = int(rng.integers(0, 8))
        q = target[r, off:off + Q].copy()
        q = np.concatenate([q, rng.integers(0, 4, Q - q.size)])
        mut = rng.random(Q) < rng.choice([0.01, 0.05, 0.3])
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        if rng.random() < 0.2:                 # an indel
            p = int(rng.integers(0, Q - 4))
            q = np.concatenate([q[:p], q[p + 3:], q[-3:]])
        query[r] = q
    query[rng.random((J, Q)) < 0.002] = 4
    target[rng.random((J, T)) < 0.002] = 4
    qlen = rng.integers(0, Q + 1, J).astype(np.int32)
    tlen = rng.integers(0, T + 1, J).astype(np.int32)
    qlen[::97] = 0
    tlen[::89] = 0
    w = rng.choice([5, 20, 100, 200], J).astype(np.int32)
    h0 = rng.integers(1, 120, J).astype(np.int32)
    bonus = np.full(J, opt.pen_clip5, np.int32)
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
    return (query, qlen, target, tlen, opt.score_matrix(), w, h0,
            bonus), kw


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare_kernel(name: str, args: tuple, kw: dict) -> dict:
    """Kernel vs plain version on the card, same inputs: exact equality on
    all six fields, and both times (CUDA events)."""
    import torch

    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_cuda import extend_core

    dev = torch.device("cuda")
    a = tuple(torch.as_tensor(x).to(dev) for x in args)
    got = extend_core(*a, **kw)
    want = _extend_core(*a, **kw)
    torch.cuda.synchronize()
    err = 0
    for field, g, p in zip(want._fields, got, want):
        diff = int((g.to(torch.int64) - p.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        check(g.shape == p.shape and diff == 0,
              f"kernel == plain on {name}, field {field} (max |diff| "
              f"{diff})")
        err = max(err, diff)
    ms = _cuda_ms(lambda: extend_core(*a, **kw), reps=20)
    plain_ms = _cuda_ms(lambda: _extend_core(*a, **kw), reps=2)
    J, Q = a[0].shape
    T = a[2].shape[1]
    print(f"[kernel] {name}: J={J} Q={Q} T={T}: kernel == plain on all 6 "
          f"fields (max |err| {err}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------- 3 ----

def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_golden(device: str = "cuda") -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg

    from tpubwa_torch.align.pipeline import align_fastq

    d = os.path.join(WORK, "golden")
    os.makedirs(d, exist_ok=True)
    ref, se_fq, _, _ = _build_fixture(d)
    buf = io.StringIO()
    t = time.monotonic()
    check(align_fastq(ref, se_fq, None, buf, device=device,
                      batch_reads=64) == 0, "golden run exits 0")
    with open(os.path.join(GOLDEN_DIR, "se.sam")) as f:
        golden = f.read()
    got = _strip_pg(buf.getvalue())
    check(got == golden, f"golden SE SAM byte-identical on {device}")
    print(f"[golden] tests/golden/se.sam reproduced byte for byte on {device} "
          f"({len(got)} bytes, {time.monotonic() - t:.1f} s)")


# ---------------------------------------------------------------- 4 ----

def realistic_fixture() -> tuple[str, str]:
    """bench.py's _ensure_fixture recipe (random genome, seed 42; reads
    seed 7), built in the checkout's build directory."""
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode

    os.makedirs(WORK, exist_ok=True)
    fa = os.path.join(WORK, f"ref_{REF_LEN}.fa")
    fq = os.path.join(WORK, f"reads_{REF_LEN}_{N_READS}_se.fq")
    t = time.monotonic()
    codes = np.random.default_rng(42).integers(0, 4, REF_LEN).astype(
        np.uint8)
    with open(fa, "w") as f:
        f.write(">benchref\n")
        seq = decode(codes)
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    FMIndex.from_fasta(fa).save(fa)
    contigs, codes, _ = read_fasta(fa)
    sim.write_fastq(fq, sim.simulate_reads(codes, contigs, N_READS,
                                           length=150, err=0.01, seed=7))
    print(f"[e2e] fixture: {REF_LEN} bp genome + index + {N_READS} reads "
          f"in {time.monotonic() - t:.1f} s")
    return fa, fq


def gate(text: str) -> None:
    prim: dict = {}
    for line in text.splitlines():
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        check(f[0] not in prim, f"one primary for {f[0]}")
        prim[f[0]] = (flag, int(f[3]))
    check(len(prim) == N_READS, f"every read has a primary ({len(prim)})")
    mapped = near = 0
    for name, (flag, pos) in prim.items():
        if flag & 4:
            continue
        mapped += 1
        near += abs(pos - 1 - int(name.split("_")[3])) <= 50
    print(f"[e2e] gates: {N_READS} primaries, mapped {mapped} "
          f"({100 * mapped / N_READS:.2f}%), within 50 bp {near} "
          f"({100 * near / N_READS:.2f}%)")
    check(mapped >= 0.97 * N_READS, ">= 97% mapped")
    check(near >= 0.92 * N_READS, ">= 92% within 50 bp of the truth")


def phase_e2e(device: str = "cuda") -> tuple[int, dict]:
    """Returns (kernel launches in the counted run, captured core
    inputs {"left": (args, kw), "right": (args, kw)})."""
    import torch

    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.ops.extend_cuda import extend_core

    fa, fq = realistic_fixture()
    idx = FMIndex.load(fa)
    aligner = Aligner(idx, MemOptions(batch_reads=BATCH), device=device)

    captured: dict = {}

    def capturing_core(*args, **kw):
        # the first left and the first right call of the run (the caller
        # is extend_jobs_left / extend_jobs_right)
        side = sys._getframe(2).f_code.co_name.rsplit("_", 1)[-1]
        if side in ("left", "right") and side not in captured:
            captured[side] = (tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw))
        return extend_core(*args, **kw)

    aligner.ext_core = capturing_core
    extend_core.launches = 0
    out = io.StringIO()
    t = time.monotonic()
    run_se_pipeline(aligner, fq, out)
    _sync(device)
    cold = time.monotonic() - t
    launches = extend_core.launches
    print(f"[e2e] counted run: {N_READS} reads in {cold:.2f} s (cold); "
          f"extension kernel launches {launches}")
    check(launches > 0, "the main path launched the extension kernel")
    check(set(captured) == {"left", "right"},
          "left and right core inputs captured")
    gate(out.getvalue())

    aligner.ext_core = extend_core
    aligner.timers = type(aligner.timers)()
    out = io.StringIO()
    _sync(device)
    t = time.monotonic()
    run_se_pipeline(aligner, fq, out)
    _sync(device)
    warm = time.monotonic() - t
    print(f"[e2e] warm run: {N_READS} reads in {warm:.2f} s = "
          f"{N_READS / warm:.1f} reads/s (batch {BATCH})")
    for name, tot in sorted(aligner.timers.totals.items(),
                            key=lambda kv: -kv[1]):
        print(f"[e2e]   {name}: {tot:.3f} s "
              f"(n={aligner.timers.counts[name]})")
    return launches, captured


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tpubwa_torch  # fails where the script lies outside a checkout

    check(os.path.dirname(os.path.dirname(os.path.abspath(
        tpubwa_torch.__file__))) == ROOT,
        f"tpubwa_torch is imported from this checkout ({ROOT})")

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    phase_build()
    args, kw = random_jobs(0, J_RAND, Q_RAND, T_RAND)
    rand = compare_kernel("random jobs", args, kw)
    phase_golden()
    launches, captured = phase_e2e()
    real = {side: compare_kernel(f"phase-4 batch 1 {side} core", a, k)
            for side, (a, k) in sorted(captured.items())}

    check("jax" not in sys.modules, "the port ran without importing jax")

    # one kernel: its error over every comparison, its times at the
    # path's full wave shape (J=8192, Q=192, T=768)
    print(json.dumps({"kernels": [dict(
        name="extend", route="cuda", source=KERNEL_SRC,
        replaces=KERNEL_REPLACES, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in [rand, *real.values()]),
        ms=rand["ms"], plain_ms=rand["plain_ms"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
