#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpubwa_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit; build the four kernels (nvcc,
   sm_90a, one process per source, all started together) and the native
   host library, with build times and ptxas register/spill lines (K5's
   for both its int32 and int64 instantiations).
2. Hold each kernel against its plain PyTorch version on the card, exact
   on every field: K1 (extend.cu) and K1b (extend_b.cu) on random jobs at
   J=8192, Q=192, T=768; K4 (localsw.cu) on random rescue jobs at J=4096,
   Q=192, T=1024 and T=256.
3. The golden fixture of tests/test_golden_sam.py through the port on the
   card must equal tests/golden/se.sam, and its pairs tests/golden/pe.sam
   under both extension layouts (t = K1, b = K1b), byte for byte.
4. SE: a 4.6 Mb random genome (seed 42), 20,000 x 150 bp reads at 1%
   error (seed 7), batch 8192: one primary per read, >= 97% mapped,
   >= 92% within 50 bp of the simulated position.  The launch counts of
   this run show the main path went through K1; its first left and right
   core inputs are captured and K1 and K1b are held to the plain version
   on them.  A warm pass gives reads/s and the phase table.
5. PE: bench.py's chr21-style repeat genome (4.6 Mb, seed 42), 10,000
   pairs of 150 bp at 1% error (seed 7, insert 400 +- 50), batch 8192.
   The counted run (layout t) must launch K1 and K4, give one primary per
   end and a SAM body whose SHA-256 equals the JAX package's (pinned
   below); its first mate-rescue round is captured and K4 is held to the
   plain version on it.  Then a warm pass under each layout, the b pass
   counted again for K1b: reads/s and the phase table.
6. K1b's ablation variants (scripts/ablate_kernel_r5.py, K1c) timed at
   that script's shapes; only the full variant is held to the plain
   version (the others are wrong by design).
7. K5 (sa_sampled.cu) on every row of phase 4's index (~9.2 M rows),
   narrow and forced wide, at shifts 2, 4 and 5: exact against its plain
   version and equal to the full SA; CUDA-event times of both at shift 5
   and the mean number of LF steps taken.
8. The index modes end to end: (a) phase 4's SE run with
   sa_sample_shift=5 (K5 counted on this run), SAM body identical to
   phase 4's, warm reads/s, device bytes of the full SA against the
   sampled SA's; (b) the same on the forced wide layout; (c) phase 5's PE
   fixture on the wide layout with sa_sample_shift=4, one counted pass,
   SAM body SHA-256 equal to the pinned JAX hash.
9. The serving modes, each body identical to the single-process one:
   phase 4's SE run with -t 4 beside -t 1 (warm reads/s); --chunks at
   batch 8192 with a deleted and a sentinel chunk, resumed, then refused
   under another batch size (manifest); two `python -m tpubwa_torch.cli
   mem --hosts 2 --host-id h --chunks DIR` processes whose chunks make
   the single-host body; --profile on the golden fixture's first 32
   reads writes a trace (with CUDA kernel events) and the same body.

The last two lines are JSON: the kernels (launches, agreement, times) and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "extend": ("tpubwa_torch/csrc/extend.cu",
               "tpubwa/ops/extend_pallas.py:211"),      # _kernel_t
    "extend_b": ("tpubwa_torch/csrc/extend_b.cu",
                 "tpubwa/ops/extend_pallas.py:51"),     # _kernel
    "localsw": ("tpubwa_torch/csrc/localsw.cu",
                "tpubwa/ops/localsw.py:84"),            # localsw_batch
    "sa_sampled": ("tpubwa_torch/csrc/sa_sampled.cu",
                   "tpubwa/ops/fm.py:323"),             # sa_lookup_sampled
}
J_RAND, Q_RAND, T_RAND = 8192, 192, 768
J_SW, Q_SW = 4096, 192
REF_LEN, N_READS, BATCH = 4_600_000, 20_000, 8192
N_PAIRS = 10_000
# SHA-256 of the SAM body (every line not starting with "@") that the JAX
# package writes for phase 5's fixture: tpubwa.align.pipeline.align_fastq,
# JAX_PLATFORMS=cpu, batch_reads=8192, all 10,000 pairs
PE_SAM_SHA256 = ("d7bdf913cc56d887f4d994bf17dc33b6"
                 "d9088a459becf8d3e5b2a62206898f5e")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def _sync(device: str = "cuda") -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters() -> dict:
    from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
    from tpubwa_torch.ops.localsw_cuda import localsw_core
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    return {"extend": extend_core, "extend_b": extend_core_b,
            "localsw": localsw_core, "sa_sampled": sa_lookup_sampled_core}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


# ---------------------------------------------------------------- 1 ----

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tpubwa_torch.align.flatext import native_lib
    from tpubwa_torch.ops import extend_cuda, localsw_cuda, sa_sampled_cuda

    builds = {"extend": lambda: extend_cuda.build("extend"),
              "extend_b": lambda: extend_cuda.build("extend_b"),
              "localsw": localsw_cuda.build,
              "sa_sampled": sa_sampled_cuda.build}

    def timed(fn):
        t = time.monotonic()
        report = fn()
        return report, time.monotonic() - t

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {name: ex.submit(timed, fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in futs.items()}
    print(f"[build] {len(builds)} kernels built in parallel in "
          f"{time.monotonic() - t0:.2f} s")
    for name, (report, dt) in done.items():
        print(f"[build] {name} ({KERNELS[name][0]}) built and loaded in "
              f"{dt:.2f} s")
        for line in report.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
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


def rescue_jobs(seed: int, J: int, Q: int, T: int) -> tuple:
    """Mate-rescue jobs as matesw_gen makes them: a 150 bp mate against a
    window holding a mutated copy of it (or not), minsc = min_seed_len *
    a; a third of the lanes are reverse passes with endsc = a score.
    Empty lanes and N codes included."""
    from tpubwa.config import MemOptions

    rng = np.random.default_rng(seed)
    opt = MemOptions()
    target = rng.integers(0, 4, (J, T)).astype(np.int32)
    query = np.full((J, Q), 4, np.int32)
    qlen = np.minimum(rng.choice([150, 150, 150, 101, Q], J), Q)
    tlen = rng.integers(T // 2, T + 1, J)
    for r in range(J):
        if r % 5:
            off = int(rng.integers(0, max(tlen[r] - qlen[r], 1)))
            q = target[r, off:off + qlen[r]].copy()
            mut = rng.random(q.size) < rng.choice([0.01, 0.04, 0.1])
            q[mut] = rng.integers(0, 4, int(mut.sum()))
        else:
            q = rng.integers(0, 4, qlen[r])
        query[r, :q.size] = q
        qlen[r] = q.size
    query[rng.random((J, Q)) < 0.002] = 4
    target[rng.random((J, T)) < 0.002] = 4
    qlen[::97] = 0
    tlen[::89] = 0
    minsc = np.full(J, opt.min_seed_len * opt.a, np.int32)
    endsc = np.where(np.arange(J) % 3 == 0, rng.integers(19, 151, J),
                     1 << 30).astype(np.int32)
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins)
    return (query, qlen.astype(np.int32), target, tlen.astype(np.int32),
            opt.score_matrix(), minsc, endsc), kw


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


def compare(kernel: str, name: str, args: tuple, kw: dict) -> dict:
    """Kernel vs its plain version on the card, same inputs: exact
    equality on every field, and both times (CUDA events).  These
    launches are not the main path's: the counters are restored."""
    import torch

    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.localsw import localsw_batch

    plain = localsw_batch if kernel == "localsw" else _extend_core
    fn = _counters()[kernel]
    n0 = fn.launches
    dev = torch.device("cuda")
    a = tuple(torch.as_tensor(x).to(dev) for x in args)
    got = fn(*a, **kw)
    want = plain(*a, **kw)
    torch.cuda.synchronize()
    err = 0
    for field, g, p in zip(want._fields, got, want):
        diff = int((g.to(torch.int64) - p.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        check(g.shape == p.shape and diff == 0,
              f"{kernel} == plain on {name}, field {field} (max |diff| "
              f"{diff})")
        err = max(err, diff)
    ms = _cuda_ms(lambda: fn(*a, **kw), reps=20)
    plain_ms = _cuda_ms(lambda: plain(*a, **kw), reps=2)
    fn.launches = n0
    J, Q = a[0].shape
    T = a[2].shape[1]
    print(f"[{kernel}] {name}: J={J} Q={Q} T={T}: kernel == plain on all "
          f"{len(want)} fields (max |err| {err}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------- 3 ----

def phase_golden(device: str = "cuda") -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg

    from tpubwa_torch.align.pipeline import align_fastq

    d = os.path.join(WORK, "golden")
    os.makedirs(d, exist_ok=True)
    ref, se_fq, fq1, fq2 = _build_fixture(d)
    runs = [("se", se_fq, None, "t"), ("pe", fq1, fq2, "t"),
            ("pe", fq1, fq2, "b")]
    for kind, r1, r2, layout in runs:
        buf = io.StringIO()
        reset_launches()
        t = time.monotonic()
        check(align_fastq(ref, r1, r2, buf, device=device, batch_reads=64,
                          ext_layout=layout) == 0, f"golden {kind} exits 0")
        _sync(device)
        n = read_launches()
        with open(os.path.join(GOLDEN_DIR, f"{kind}.sam")) as f:
            golden = f.read()
        got = _strip_pg(buf.getvalue())
        check(got == golden, f"golden {kind.upper()} SAM byte-identical on "
              f"{device} (layout {layout})")
        core = "extend_b" if layout == "b" else "extend"
        check(n[core] > 0, f"golden {kind} layout {layout} launched {core}")
        print(f"[golden] tests/golden/{kind}.sam reproduced byte for byte on "
              f"{device}, layout {layout} ({len(got)} bytes, "
              f"{time.monotonic() - t:.1f} s; launches {n})")


# ---------------------------------------------------------------- 4 ----

def write_fasta(path: str, codes: np.ndarray) -> None:
    from tpubwa.index.fmindex import FMIndex
    from tpubwa.utils.dna import decode

    with open(path, "w") as f:
        f.write(">benchref\n")
        seq = decode(codes)
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    FMIndex.from_fasta(path).save(path)


def realistic_fixture() -> tuple[str, str]:
    """bench.py's _ensure_fixture recipe (random genome, seed 42; reads
    seed 7), built in the checkout's build directory."""
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim

    os.makedirs(WORK, exist_ok=True)
    fa = os.path.join(WORK, f"ref_{REF_LEN}.fa")
    fq = os.path.join(WORK, f"reads_{REF_LEN}_{N_READS}_se.fq")
    t = time.monotonic()
    write_fasta(fa, np.random.default_rng(42).integers(0, 4, REF_LEN)
                .astype(np.uint8))
    contigs, codes, _ = read_fasta(fa)
    sim.write_fastq(fq, sim.simulate_reads(codes, contigs, N_READS,
                                           length=150, err=0.01, seed=7))
    print(f"[se] fixture: {REF_LEN} bp genome + index + {N_READS} reads "
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
    print(f"[se] gates: {N_READS} primaries, mapped {mapped} "
          f"({100 * mapped / N_READS:.2f}%), within 50 bp {near} "
          f"({100 * near / N_READS:.2f}%)")
    check(mapped >= 0.97 * N_READS, ">= 97% mapped")
    check(near >= 0.92 * N_READS, ">= 92% within 50 bp of the truth")


def print_phases(tag: str, timers) -> None:
    for name, tot in sorted(timers.totals.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {name}: {tot:.3f} s (n={timers.counts[name]})")


def phase_se(device: str = "cuda") -> dict:
    """Returns the captured core inputs {"left": (args, kw), "right":
    (args, kw)} of the counted run, and the fixture, aligner and SAM body
    for phases 7-9."""
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
    out = io.StringIO()
    _sync(device)
    reset_launches()
    t = time.monotonic()
    run_se_pipeline(aligner, fq, out)
    _sync(device)
    cold = time.monotonic() - t
    launches = read_launches()
    print(f"[se] counted run: {N_READS} reads in {cold:.2f} s (cold); "
          f"launches {launches}")
    check(launches["extend"] > 0, "the SE path launched the extension "
          "kernel")
    check(set(captured) == {"left", "right"},
          "left and right core inputs captured")
    gate(out.getvalue())
    body = out.getvalue()

    aligner.ext_core = extend_core
    aligner.timers = type(aligner.timers)()
    out = io.StringIO()
    _sync(device)
    t = time.monotonic()
    run_se_pipeline(aligner, fq, out)
    _sync(device)
    warm = time.monotonic() - t
    print(f"[se] warm run: {N_READS} reads in {warm:.2f} s = "
          f"{N_READS / warm:.1f} reads/s (batch {BATCH})")
    print_phases("se", aligner.timers)
    return dict(captured=captured, fa=fa, fq=fq, idx=idx, aligner=aligner,
                body=body)


# ---------------------------------------------------------------- 5 ----

def pe_fixture() -> tuple[str, str, str]:
    """bench.py's PE chr21-style recipe (TPUBWA_BENCH_PE=1
    TPUBWA_BENCH_STYLE=chr21), built in the checkout's build directory."""
    from bench import _repeat_genome   # framework-free; imports numpy only
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim

    os.makedirs(WORK, exist_ok=True)
    fa = os.path.join(WORK, f"ref_{REF_LEN}_chr21.fa")
    fq1 = os.path.join(WORK, f"pairs_{REF_LEN}_{N_PAIRS}_1.fq")
    fq2 = os.path.join(WORK, f"pairs_{REF_LEN}_{N_PAIRS}_2.fq")
    t = time.monotonic()
    write_fasta(fa, _repeat_genome(np.random.default_rng(42), REF_LEN))
    contigs, codes, _ = read_fasta(fa)
    r1, r2 = sim.simulate_pairs(codes, contigs, N_PAIRS, length=150,
                                err=0.01, seed=7)
    sim.write_fastq(fq1, r1)
    sim.write_fastq(fq2, r2)
    print(f"[pe] fixture: {REF_LEN} bp chr21-style genome + index + "
          f"{N_PAIRS} pairs in {time.monotonic() - t:.1f} s")
    return fa, fq1, fq2


def pe_gate(text: str) -> None:
    body = "".join(ln for ln in text.splitlines(keepends=True)
                   if not ln.startswith("@"))
    prim = set()
    mapped = proper = 0
    for line in body.splitlines():
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        key = (f[0], flag & 0xC0)
        check(key not in prim, f"one primary for {key}")
        prim.add(key)
        mapped += not flag & 4
        proper += bool(flag & 2)
    n = 2 * N_PAIRS
    check(len(prim) == n, f"every end has a primary ({len(prim)} of {n})")
    digest = hashlib.sha256(body.encode()).hexdigest()
    print(f"[pe] gates: {n} primaries, mapped {mapped} "
          f"({100 * mapped / n:.2f}%), proper pair {proper} "
          f"({100 * proper / n:.2f}%); SAM body sha256 {digest}")
    check(digest == PE_SAM_SHA256, "PE SAM body equals the JAX package's "
          f"(sha256 {PE_SAM_SHA256})")


def phase_pe(device: str = "cuda") -> tuple[dict, dict, tuple, tuple]:
    """Returns (launches of the counted layout-t run, launches of the
    layout-b pass, the first captured mate-rescue round (args, kw), the
    fixture's (fa, fq1, fq2))."""
    import torch

    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa_torch.align import pair
    from tpubwa_torch.align.pipeline import EXT_CORES, Aligner

    fa, fq1, fq2 = pe_fixture()
    idx = FMIndex.load(fa)
    aligner = Aligner(idx, MemOptions(batch_reads=BATCH), device=device)
    core = pair.localsw_core
    captured: list = []

    def capturing(*args, **kw):
        if not captured:
            captured.append((tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in args), dict(kw)))
        return core(*args, **kw)

    pair.localsw_core = capturing
    try:
        out = io.StringIO()
        _sync(device)
        reset_launches()
        t = time.monotonic()
        rc = pair.align_pe_fastq(aligner, fq1, fq2, out)
        _sync(device)
        cold = time.monotonic() - t
        launches = read_launches()
    finally:
        pair.localsw_core = core
    check(rc == 0, "PE run exits 0")
    print(f"[pe] counted run (layout t): {2 * N_PAIRS} reads in "
          f"{cold:.2f} s (cold); launches {launches}")
    check(launches["extend"] > 0, "the PE path launched K1")
    check(launches["localsw"] > 0, "the PE path launched K4 (mate rescue)")
    check(len(captured) == 1, "first mate-rescue round captured")
    pe_gate(out.getvalue())

    b_launches = {}
    for layout in ("t", "b"):
        aligner.ext_core = EXT_CORES[layout]
        aligner.timers = type(aligner.timers)()
        out = io.StringIO()
        _sync(device)
        reset_launches()
        t = time.monotonic()
        check(pair.align_pe_fastq(aligner, fq1, fq2, out) == 0,
              f"PE layout {layout} exits 0")
        _sync(device)
        warm = time.monotonic() - t
        n = read_launches()
        print(f"[pe] warm run, layout {layout}: {2 * N_PAIRS} reads in "
              f"{warm:.2f} s = {2 * N_PAIRS / warm:.1f} reads/s (batch "
              f"{BATCH}); launches {n}")
        print_phases("pe", aligner.timers)
        if layout == "b":
            check(n["extend_b"] > 0 and n["extend"] == 0,
                  "the layout-b pass launched K1b and not K1")
            pe_gate(out.getvalue())
            b_launches = n
    return launches, b_launches, captured[0], (fa, fq1, fq2)


# ---------------------------------------------------------------- 6 ----

def phase_ablation() -> dict:
    """scripts/ablate_kernel_r5.py's seven variants on K1b at its shapes:
    B=4096, Q=192, T=256, target = copy of the query, w=100, h0=1."""
    import torch

    from tpubwa.config import MemOptions
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.extend_cuda import VARIANTS, extend_b_variant

    B, Q, T = 4096, 192, 256
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    t = np.zeros((B, T), np.int32)
    t[:, :min(Q, T)] = q[:, :min(Q, T)]
    opt = MemOptions()       # a=1 b=4, gaps 6+1: the script's scores
    dev = torch.device("cuda")
    args = [torch.as_tensor(x, device=dev) for x in (
        q, np.full(B, Q, np.int32), t, np.full(B, T, np.int32),
        opt.score_matrix(), np.full(B, 100, np.int32),
        np.full(B, 1, np.int32), np.zeros(B, np.int32))]
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=100, mat_max=opt.a)
    got = extend_b_variant("full", *args, **kw)
    want = _extend_core(*args, **kw)
    torch.cuda.synchronize()
    for field, g, p in zip(want._fields, got, want):
        check(torch.equal(g, p), f"ablation full variant == plain, {field}")
    times = {v: _cuda_ms(lambda v=v: extend_b_variant(v, *args, **kw),
                         reps=10) for v in VARIANTS}
    print("[ablate] K1b variants, B=4096 Q=192 T=256 (full == plain): "
          + "  ".join(f"{v} {ms:.3f} ms" for v, ms in times.items()))
    return times


# ---------------------------------------------------------------- 7 ----

def phase_k5(idx) -> dict:
    """K5 against its plain version and the full SA on every row of
    `idx`, narrow and wide, shifts 2, 4 and 5; times at shift 5."""
    import torch

    from tpubwa_torch.ops.fm import (DeviceIndex, build_sampled_sa,
                                     sa_lookup_sampled)
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    k5 = sa_lookup_sampled_core
    n0 = k5.launches
    dev = torch.device("cuda")
    sa = torch.as_tensor(idx.sa, device=dev)               # int64 [N+1]
    n = sa.numel()
    err, times = 0, {}
    for wide in (False, True):
        layout = "wide" if wide else "narrow"
        di = DeviceIndex.from_host(idx, dev, wide=wide, sa_stub=True)
        rows = torch.arange(n, device=dev,
                            dtype=torch.int64 if wide else torch.int32)
        for shift in (2, 4, 5):
            ss = build_sampled_sa(None, shift, wide, idx=idx, device=dev)
            got = k5(di, ss, rows, shift)
            want = sa_lookup_sampled(di, ss, rows, shift)
            torch.cuda.synchronize()
            diff = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                       .max())
            check(got.dtype == rows.dtype and diff == 0,
                  f"K5 == plain on all {n} rows ({layout}, shift {shift}; "
                  f"max |diff| {diff})")
            check(torch.equal(got.to(torch.int64), sa),
                  f"K5 == the full SA ({layout}, shift {shift})")
            err = max(err, diff)
            line = (f"[k5] {layout} shift {shift}: {n} rows == plain == "
                    "full SA")
            if shift == 5:
                ms = _cuda_ms(lambda: k5(di, ss, rows, shift), reps=10)
                plain_ms = _cuda_ms(
                    lambda: sa_lookup_sampled(di, ss, rows, shift), reps=2)
                steps = float((sa % (1 << shift)).double().mean())
                times[layout] = dict(ms=ms, plain_ms=plain_ms)
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                         f"mean LF steps {steps:.3f} (of at most "
                         f"{(1 << shift) - 1})")
            print(line)
    k5.launches = n0
    return dict(max_abs_err=err, **times["narrow"])


# ---------------------------------------------------------------- 8 ----

def _timed_se(aligner, fq: str, workers: int = 1) -> tuple[str, float]:
    """(SAM body, seconds) of one SE pass over `fq`."""
    from tpubwa_torch.align.pipeline import run_se_pipeline

    out = io.StringIO()
    _sync()
    t = time.monotonic()
    run_se_pipeline(aligner, fq, out, workers=workers)
    _sync()
    return out.getvalue(), time.monotonic() - t


def phase_index_modes(se: dict, pe_files: tuple) -> dict:
    """Returns the launches of the sampled-SA SE run (a)."""
    import torch

    from tpubwa.config import MemOptions
    from tpubwa.index.fmindex import FMIndex
    from tpubwa_torch.align import pair
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa

    dev = torch.device("cuda")
    idx, fq, body = se["idx"], se["fq"], se["body"]

    # (a) sampled SA, bwa's default interval of 32
    al = Aligner(idx, MemOptions(batch_reads=BATCH, sa_sample_shift=5),
                 device=dev)
    _sync()
    reset_launches()
    text, cold = _timed_se(al, fq)
    launches = read_launches()
    check(launches["sa_sampled"] > 0, "the --sa-shift 5 run launched K5")
    check(text == body, "--sa-shift 5 SAM body == phase 4's")
    text, warm = _timed_se(al, fq)
    check(text == body, "--sa-shift 5 warm SAM body == phase 4's")
    full = se["aligner"].di.sa
    full_b = full.numel() * full.element_size()
    ss_b = sum(t.numel() * t.element_size() for t in al.ss)
    print(f"[8a] --sa-shift 5: body == phase 4's ({cold:.2f} s cold); warm "
          f"{N_READS / warm:.1f} reads/s; launches {launches}; device SA "
          f"bytes: full {full_b} vs sampled {ss_b} (blocks + vals, "
          f"{full_b / ss_b:.2f}x less)")

    # (b) the wide layout, forced
    al = Aligner(idx, MemOptions(batch_reads=BATCH), device=dev)
    al.di = DeviceIndex.from_host(idx, dev, wide=True)
    text, cold = _timed_se(al, fq)
    check(text == body, "wide-layout SAM body == phase 4's")
    text, warm = _timed_se(al, fq)
    check(text == body, "wide-layout warm SAM body == phase 4's")
    print(f"[8b] wide layout: body == phase 4's ({cold:.2f} s cold); warm "
          f"{N_READS / warm:.1f} reads/s")

    # (c) PE, wide with the sampled SA (shift 4), one counted pass
    fa, fq1, fq2 = pe_files
    pidx = FMIndex.load(fa)
    al = Aligner(pidx, MemOptions(batch_reads=BATCH, sa_sample_shift=4),
                 device=dev)
    al.di = DeviceIndex.from_host(pidx, dev, wide=True, sa_stub=True)
    al.ss = build_sampled_sa(None, 4, True, idx=pidx, device=dev)
    out = io.StringIO()
    _sync()
    reset_launches()
    t = time.monotonic()
    check(pair.align_pe_fastq(al, fq1, fq2, out) == 0,
          "wide + sampled PE exits 0")
    _sync()
    n = read_launches()
    check(n["sa_sampled"] > 0 and n["localsw"] > 0,
          "wide + sampled PE launched K5 and K4")
    print(f"[8c] PE wide + --sa-shift 4: {2 * N_PAIRS} reads in "
          f"{time.monotonic() - t:.2f} s; launches {n}")
    pe_gate(out.getvalue())
    return launches


# ---------------------------------------------------------------- 9 ----

def _body(sam: str) -> str:
    return "".join(ln for ln in sam.splitlines(keepends=True)
                   if not ln.startswith("@"))


def phase_serving(se: dict) -> None:
    import contextlib
    import shutil

    from tpubwa_torch import cli
    from tpubwa_torch.align.pipeline import align_fastq

    fa, fq, body = se["fa"], se["fq"], se["body"]

    # -t 4 beside -t 1 on phase 4's aligner; -t 4 twice, the second pass
    # on a caching allocator already grown to three batches in flight
    rates = []
    for workers in (1, 4, 4):
        text, dt = _timed_se(se["aligner"], fq, workers=workers)
        check(text == body, f"-t {workers} SAM body == phase 4's")
        rates.append(N_READS / dt)
    print(f"[9] -t 1 {rates[0]:.1f} reads/s, -t 4 {rates[1]:.1f} then "
          f"{rates[2]:.1f} reads/s (warm; bodies identical)")

    # --chunks: run, lose one chunk, poison another, resume twice
    cdir = os.path.join(WORK, "chunks")
    shutil.rmtree(cdir, ignore_errors=True)

    def run_chunked(batch=BATCH) -> str:
        buf = io.StringIO()
        check(align_fastq(fa, fq, None, buf, device="cuda",
                          batch_reads=batch, chunk_dir=cdir) == 0,
              "chunked run exits 0")
        return _body(buf.getvalue())

    check(run_chunked() == body, "--chunks SAM body == phase 4's")
    chunks = sorted(c for c in os.listdir(cdir) if c.startswith("chunk_"))
    check(len(chunks) == 3, f"3 chunks at batch {BATCH} ({chunks})")
    os.remove(os.path.join(cdir, chunks[2]))
    sentinel = os.path.join(cdir, chunks[0])
    with open(sentinel) as f:
        keep = f.read()
    with open(sentinel, "w") as f:
        f.write("SENTINEL\n")
    check("SENTINEL\n" in run_chunked(), "the sentinel chunk came back "
          "verbatim (not recomputed)")
    with open(sentinel, "w") as f:
        f.write(keep)
    check(run_chunked() == body, "resumed --chunks body == phase 4's")
    try:
        run_chunked(batch=BATCH // 2)
        refused = False
    except RuntimeError as e:
        refused = "manifest" in str(e)
    check(refused, "a run with another batch size is refused on the "
          "manifest")
    print("[9] --chunks: body identical; a deleted chunk recomputed, the "
          "sentinel reused verbatim, body identical after restoring it; "
          "another batch size refused on the manifest")

    # two host processes meeting in one chunk directory
    hdir = os.path.join(WORK, "hosts")
    shutil.rmtree(hdir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpubwa_torch.cli", "mem", "--device", "cuda",
         "--batch", str(BATCH), "--hosts", "2", "--host-id", str(h),
         "--chunks", hdir, fa, fq], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for h in (0, 1)]
    try:
        errs = [p.communicate(timeout=400)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for h, (p, e) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"host {h} exits 0: {e[-2000:]}")
    files = sorted(f for f in os.listdir(hdir) if f.startswith("chunk_"))
    merged = "".join(open(os.path.join(hdir, f)).read() for f in files)
    check(len(files) == 3 and merged == body,
          "the two hosts' chunks concatenate to the single-host body")
    print(f"[9] --hosts 2: two processes in {time.monotonic() - t:.1f} s; "
          f"chunks {files} concatenate to the single-host body")

    # --profile on the golden fixture's reference and first 32 reads (a
    # trace of all 300 reads runs to gigabytes)
    g = os.path.join(WORK, "golden")
    ref = os.path.join(g, "golden_ref.fa")
    fq32 = os.path.join(WORK, "golden_se_32.fq")
    with open(os.path.join(g, "se.fq")) as f:
        head = [next(f) for _ in range(4 * 32)]
    with open(fq32, "w") as f:
        f.writelines(head)
    plain = io.StringIO()
    check(align_fastq(ref, fq32, None, plain, device="cuda",
                      batch_reads=32) == 0, "32-read golden run exits 0")
    tdir = os.path.join(WORK, "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["mem", "--device", "cuda", "--batch", "32",
                       "--profile", tdir, ref, fq32])
    check(rc == 0, "--profile run exits 0")
    check(_body(buf.getvalue()) == _body(plain.getvalue()),
          "--profile SAM body == the run without it")
    traces = [os.path.join(tdir, f) for f in os.listdir(tdir)]
    check(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
          "--profile wrote a trace file")
    with open(traces[0]) as f:
        cuda_events = f.read().count('"cat": "kernel"')
    print(f"[9] --profile (golden reference, 32 reads): {traces[0]} "
          f"({os.path.getsize(traces[0])} bytes, {cuda_events} CUDA kernel "
          "events), body identical")


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

    t_start = time.monotonic()
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    phase_build()
    args, kw = random_jobs(0, J_RAND, Q_RAND, T_RAND)
    res = {k: [compare(k, "random jobs", args, kw)]
           for k in ("extend", "extend_b")}
    res["localsw"] = [compare("localsw", f"random rescue jobs T={T}",
                              *rescue_jobs(T, J_SW, Q_SW, T))
                      for T in (1024, 256)]
    phase_golden()
    se = phase_se()
    for side, (a, k) in sorted(se["captured"].items()):
        for kern in ("extend", "extend_b"):
            res[kern].append(compare(kern, f"SE batch 1 {side} core", a, k))
    pe_launches, b_launches, (sw_args, sw_kw), pe_files = phase_pe()
    sw_real = compare("localsw", "PE batch 1 first rescue round", sw_args,
                      sw_kw)
    res["localsw"].append(sw_real)
    phase_ablation()
    k5 = phase_k5(se["idx"])
    res["sa_sampled"] = [k5]
    k5_launches = phase_index_modes(se, pe_files)
    phase_serving(se)

    check("jax" not in sys.modules, "the port ran without importing jax")
    print(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")

    # launches: each kernel's count in the run that drives it (K1 and K4
    # in phase 5's counted layout-t run, K1b in its layout-b pass, K5 in
    # phase 8(a)'s --sa-shift 5 run); error over every comparison; times
    # at the path's shapes (K1/K1b: the full wave J=8192 Q=192 T=768; K4:
    # the PE run's first rescue round; K5: every row of the SE index at
    # shift 5, narrow)
    launches = dict(extend=pe_launches["extend"],
                    extend_b=b_launches["extend_b"],
                    localsw=pe_launches["localsw"],
                    sa_sampled=k5_launches["sa_sampled"])
    timing = dict(extend=res["extend"][0], extend_b=res["extend_b"][0],
                  localsw=sw_real, sa_sampled=k5)
    print(json.dumps({"kernels": [dict(
        name=k, route="cuda", source=KERNELS[k][0], replaces=KERNELS[k][1],
        launches=launches[k],
        max_abs_err=max(r["max_abs_err"] for r in res[k]),
        ms=timing[k]["ms"], plain_ms=timing[k]["plain_ms"])
        for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
