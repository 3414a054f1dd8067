#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpubwa_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit; build the six kernel sources
   (nvcc, sm_90a, one process per source, all started together) and the
   native host library (g++), with build times and ptxas register/spill
   lines (K2's and K5's for both their int32 and int64 instantiations);
   K1b and K5 must report no spills.
2. Hold each kernel against its plain PyTorch version on the card, exact
   on every field: K1 (extend.cu) and K1b (extend_b.cu) on random jobs at
   J=8192, Q=192, T=768; K4 (localsw.cu) on random rescue jobs at J=4096,
   Q=192, T=1024 and T=256; K1, K1b and K4 also on the adversarial job
   sets of tpubwa_torch.utils.sim (edge_sets below), and every comparison of
   K1, K1b and K4 prints the cells a job visits (mean, p99, max) and the
   hand kernel's own device time inside its wrapper (torch.profiler), and
   K1's prep kernel (band clamp, sort keys) is held to its plain version
   on every job set K1 sees; K2 (smem_chain.cu) on the first 8192 reads of
   phase 4's and of phase 5's fixture, narrow and forced wide: rounds 1
   and 3, round 2 on the candidates round 1 gives, and all three at caps
   small enough to overflow, whole buffers (k, l, s, start, end, n,
   overflow), with the steps a lane takes (mean, p99, max) and the time
   of one step on the longest chain (kernel ms / max steps, the floor of
   a launch) per round; K3 (global_align.cu) on 8192 synthetic lanes
   (long gaps, nseg > GA_K, one-base target and query, band at cap and
   floor): the pack of _ga_rows and the executor's step rows; K2 and K3
   also on the adversarial sets of tpubwa_torch.utils.sim (K2: reads of
   one high-copy repeat, N at the ends and in runs, empty and too short
   reads, a cap of 1, one long chain among short ones in a warp, a batch
   that is a multiple of no block size, narrow and wide; K3: w = -1, 0 and
   >= Q + T, the corner outside the band, qlen and tlen 0 and 1, nseg >
   GA_K, long leading and trailing deletions, at 192x256, 64x128 and
   320x512, M = 1103 and M = 1).  CUDA-event times of kernel and plain;
   each kernel's bound from the work these inputs need.
3. The golden fixture (the recipe of tests/test_golden_sam.py, made here
   with the port's own index builder and simulator) through the port on
   the card must equal tests/golden/se.sam, and its pairs
   tests/golden/pe.sam under both extension layouts (t = K1, b = K1b),
   byte for byte.
4. SE: a 4.6 Mb random genome (seed 42), 20,000 x 150 bp reads at 1%
   error (seed 7), batch 8192: one primary per read, >= 97% mapped,
   >= 92% within 50 bp of the simulated position.  The launch counts of
   this run show the main path went through K2, K1 and K3; the core
   inputs of its first left and right wave, each with its retry launch
   (mostly dead lanes), are captured and K1 and K1b are held to the plain
   version on them (a [k1b] line a wave: K1b beside K1, and how much of
   a row the clamped band covers), and K3 on the lanes of every _ga_rows
   call of the
   run (the non-exact lanes of each band-doubling round), one line a call:
   round, lanes, band cells, widest band, kernel ms.  A warm pass gives reads/s and the
   phase table; a profiled pass (torch.profiler) the number of device
   kernels and the device-busy share.  Beside K2's times: the card's rate
   for independent gathers from this index's checkpoint table, and the
   time of one dependent gather (tpubwa_torch.utils.gather_latency: one
   warp alone, with shuffles on the chain, and 2,048 warps at once).
5. PE: bench.py's chr21-style repeat genome (4.6 Mb, seed 42), 10,000
   pairs of 150 bp at 1% error (seed 7, insert 400 +- 50), batch 8192.
   The counted run (layout t) must launch K2, K1, K4 and K3, give one
   primary per end and a SAM body whose SHA-256 equals the JAX package's
   (pinned below); its first mate-rescue round is captured and K4 is held
   to the plain version on it, and K3 on every _ga_rows call (one line a
   call, as in phase 4).  Then
   a warm pass under each layout, the b pass counted again for K1b:
   reads/s and the phase table; then a profiled pass (layout t): device
   time by kernel and the totals of the port's own kernels.
6. K1b's ablation variants (scripts/ablate_kernel_r5.py, K1c) timed at
   that script's shapes; only the full variant is held to the plain
   version (the others are wrong by design).
7. K5 (sa_sampled.cu) on every row of phase 4's index (~9.2 M rows),
   narrow and forced wide, at shifts 2, 4 and 5, and on the edge rows of
   utils.sim.sa_edge_rows at shifts 0, 1, 2, 4 and 5: exact against its
   plain version and equal to the full SA; CUDA-event times of both at
   shift 5, the kernel also on the card's clock, the LF steps a row
   (mean, max) and the share of lane-turns a thread-per-row warp keeps
   busy (from the SA, on the host).
8. The index modes end to end: (a) phase 4's SE run with
   sa_sample_shift=5 (K5 counted on this run), SAM body identical to
   phase 4's, warm reads/s, device bytes of the full SA against the
   sampled SA's; each K5 call of that run captured and held to the plain
   version, one line a call: rows, live rows, kernel ms (events and the
   card's clock), plain ms, bound, and the kernel on every row of the
   buffer (the first design's way);
   (b) the same on the forced wide layout; (c) phase 5's PE
   fixture on the wide layout with sa_sample_shift=4, one counted pass,
   SAM body SHA-256 equal to the pinned JAX hash.
9. The serving modes, each body identical to the single-process one:
   phase 4's SE run with -t 4 beside -t 1 (warm reads/s); --chunks at
   batch 8192 with a deleted and a sentinel chunk, resumed, then refused
   under another batch size (manifest); two `python -m tpubwa_torch.cli
   mem --hosts 2 --host-id h --chunks DIR` processes whose chunks make
   the single-host body; --profile on the golden fixture's first 32
   reads writes a trace (with CUDA kernel events) and the same body.
10. The device mesh (preset v5e-4: 4 shards, batch 32768) on
   ["cuda:0"] * 4, each body identical to one device's at batch 32768:
   (a) phase 4's SE fixture, cold and warm beside one shard, with the K2,
   K1 and K3 launches of both runs (K2's rounds 1 and 3 once a shard and
   batch; round 2 once a wave, none on a shard without candidates), warm
   reads/s, the phase tables and the SA each shard reads; (b) phase 5's PE
   fixture the same way (one batch of 10,000 pairs: the pinned hash is
   at batch 8192, and pestat is per batch); (c) SE with the SA sharded
   over the 4 shards, each holding (N+1) padded / 4 rows; (d) PE on the
   forced wide layout with the SA sharded; (e) SE with --sa-shift 5 on
   every shard (K5 launched); (f) `python -m tpubwa_torch.cli mem
   --preset v5e-4 --device cuda:0,cuda:0,cuda:0,cuda:0` on the golden
   fixture equals the one-device CLI at batch 32768 and, but @PG,
   tests/golden/se.sam; (g) `--preset v5e-4 --device cuda` exits 1 with
   one line on fewer than 4 cards (on 4 or more it runs and equals (f));
   (h) with two cards, (a) on cuda:0 and cuda:1.
11. A genome of real size: tpubwa_torch.utils.gensim's realistic genome
   (segmental duplications, an Alu-like family, microsatellites,
   homopolymer runs, GC skew, N-islands written as N) at the length of
   GRCh38 chr21, 46,709,983 bp (seed 1234); 20,000 SE reads and 10,000
   pairs as in phases 4 and 5, batch 8192.  (a) The index build, timed.
   (b) SE: a counted run (K2, K1, K3 launched; its first K1 waves and
   every _ga_rows call captured) whose SAM body's SHA-256 equals the JAX
   package's (pinned below), three warm passes (reads/s, launches, the
   phase table), a profiled pass; (c) PE the same, K4 launched, its own
   pinned hash; (d) --sa-shift 5 (K5 launched, its calls captured) and
   the forced wide layout, each SE body equal to (b)'s, with the device
   bytes of each layout; (e) on this index, K2's three rounds on the
   first SE batch (narrow and wide, steps a lane, us a step), the
   captured K1 waves, K3 calls and first K4 rescue round, and (d)'s K5
   calls against their plain versions; (f) the dependent-gather time over
   this index's checkpoint table, the wide table and the SA (the last two
   larger than the L2 cache); (g) values at and above 2^31: K5 against
   its plain version and the SA on utils.sim.high_word_index (counts and
   SA values + 2^31 + 12,345), and K2's three rounds and K5 on the index
   with its rows moved up by 2^31 + 12,352 (against the plain versions
   and the unmoved index's results); (h) 2x250 pairs (insert 550 +- 100,
   10,000 pairs) through align_pe_fastq: every batch in the wide bucket,
   one primary an end, no rescue job cut, the generator tier at most 1 %
   of the reads, the counters printed, and the run's own kernel calls
   against their plain versions: its first left and right K1 waves (and
   their retries) at Q 256, under K1 and K1b; its first call of each of
   K2's three rounds on the 256-wide codes; its first K4 round (Q 256,
   T 2,048); and its K3 calls (Q 256, T 384).
12. The per-read and fused paths.  (a) The first batch of phase 4's SE
   reads and of phase 5's read-1 ends (repeats, multi-region) through
   Aligner.seed_batch -> chain_batch (native chaining) ->
   extend_batch_rounds (one extend_read generator a read, lockstep
   rounds of extend_seed_batch) under layouts t (K1) and b (K1b), each
   run counted (rounds, lanes in the first and last round, K1 / K1b / K2
   launches, seconds, the phase table): regions equal to the flat
   engine's regions_batch field for field, and the native chains equal
   to chain_read + filter_chains.  (b) parallel.mesh.device_align_step on
   SE batch 1 at 8,192 x 160 (K2 and K1 launched, CUDA-event ms): its
   seed slots equal smems_to_seeds', its compact_seeds rows equal
   seed_rows' on the reads that hit no cap, its scores equal the plain
   _extend_core on the same windows (and K1 is compared there), and
   sharded_align_step on ["cuda:0"] * 4 equals one device.  (c) K1 and
   K1b against the scalar oracle extend_ref on 512 random jobs, K2
   against fm_ref.collect_smems on 64 reads of SE batch 1.  (d) An index
   built by NumPy prefix doubling equals the native SA-IS build (200 kb,
   host only).
13. The port's measurement programs on the card.  (a) tools.bench (the
   port of bench.py) at bench.py's four configurations, 3 passes each:
   SE on the 4.6 Mb random genome (phase 4's files: its body hash equals
   phase 4's body), SE and PE (10,000 pairs) on a 46 Mb chr21-style
   genome (bench.py's 46 Mb fixture, built here once: its index build
   timed; the body hashes equal the JAX package's, pinned below), and
   --kernel under layouts t (K1) and b (K1b): the last call's scores
   equal the plain version's, the launch counter grew by the calls made,
   visited Gcells/s and its share of the card's bound.  One record a
   line.  (b) tools.profile_se (scripts/profile_r4.py) on the 4.6 Mb
   random and the 46 Mb chr21-style SE fixtures, (c) tools.profile_pe
   (scripts/profile_pe_r5.py) on the 46 Mb PE fixture: stage times, the
   cProfile table, one record each; each tool checks that its replayed
   text equals the production path's.  Every record names the card.

Before the last line: one JSON line of the seven kernels (launches on the
path that runs them, agreement, kernel / plain / bound times), then the
card line again.  The last line is {"ok": true, "device": {...}}.

A kernel's bound is the larger of (bytes it must move) / HBM_BPS and
(integer operations on this run's data) / INT32_OPS; the operation counts
per unit of work are the OPS_* constants of tpubwa_torch.utils.roofline
(which tools.bench --kernel uses too): what the function needs
for one band cell, traceback step, extension step or LF step, not what a
kernel happens to execute.  The units are counted on this run's data: band
cells visited, traceback steps taken, extension steps of every chain.
No single PyTorch call computes any of these functions, so library_ms is
null throughout.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

from tpubwa_torch.utils.roofline import (HBM_BPS, INT32_OPS, OPS_CHAIN_STEP,
                                         OPS_EXT_CELL, OPS_GA_CELL,
                                         OPS_GA_STEP, OPS_LF_STEP,
                                         OPS_SW_CELL)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "extend": ("tpubwa_torch/csrc/extend.cu",
               "tpubwa/ops/extend_pallas.py:211"),      # _kernel_t
    "extend_b": ("tpubwa_torch/csrc/extend_b.cu",
                 "tpubwa/ops/extend_pallas.py:51"),     # _kernel
    "extend_b_variant": ("tpubwa_torch/csrc/extend_b.cu",
                         "scripts/ablate_kernel_r5.py:37"),   # make_kernel
    "smem_chain": ("tpubwa_torch/csrc/smem_chain.cu",
                   "tpubwa/ops/smem_chain.py:109"),     # the three chains
    "global_align": ("tpubwa_torch/csrc/global_align.cu",
                     "tpubwa/ops/global_align.py:142"),  # fill + traceback
    "localsw": ("tpubwa_torch/csrc/localsw.cu",
                "tpubwa/ops/localsw.py:84"),            # localsw_batch
    "sa_sampled": ("tpubwa_torch/csrc/sa_sampled.cu",
                   "tpubwa/ops/fm.py:323"),             # sa_lookup_sampled
}
# kernel -> what its __global__ function's name contains
KERNEL_FUNCS = {"extend": "extend_kernel", "extend_b": "extend_b_kernel",
                "localsw": "localsw_kernel"}
J_RAND, Q_RAND, T_RAND = 8192, 192, 768
J_SW, Q_SW = 4096, 192
REF_MB, N_READS, BATCH = 4.6, 20_000, 8192
REF_LEN = int(REF_MB * 1e6)
N_PAIRS = 10_000
# SHA-256 of the SAM body (every line not starting with "@") that the JAX
# package writes for phase 5's fixture: tpubwa.align.pipeline.align_fastq,
# JAX_PLATFORMS=cpu, batch_reads=8192, all 10,000 pairs
PE_SAM_SHA256 = ("d7bdf913cc56d887f4d994bf17dc33b6"
                 "d9088a459becf8d3e5b2a62206898f5e")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _sync(device: str = "cuda") -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters() -> dict:
    """kernel -> the wrappers that launch it (each counts its own)."""
    from tpubwa_torch.ops import global_align_cuda as k3
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.extend_cuda import (extend_b_variant, extend_core,
                                              extend_core_b)
    from tpubwa_torch.ops.localsw_cuda import localsw_core
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    return {"extend": (extend_core,), "extend_b": (extend_core_b,),
            "extend_b_variant": (extend_b_variant,),
            "smem_chain": (k2.smem_round1_core, k2.smem_through_core,
                           k2.smem_round3_core),
            "global_align": (k3.ga_pack, k3.global_align_cigar_core),
            "localsw": (localsw_core,),
            "sa_sampled": (sa_lookup_sampled_core,)}


def reset_launches() -> None:
    for fns in _counters().values():
        for fn in fns:
            fn.launches = 0


def read_launches() -> dict:
    return {k: sum(fn.launches for fn in fns)
            for k, fns in _counters().items()}


class keep_launches:
    """Launches made inside are comparisons, not the main path's: every
    counter is put back on exit."""

    def __enter__(self):
        self.saved = [(fn, fn.launches) for fns in _counters().values()
                      for fn in fns]

    def __exit__(self, *exc):
        for fn, n in self.saved:
            fn.launches = n


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the int32 rate, whichever is larger."""
    by_bytes = n_bytes / HBM_BPS * 1e3
    by_ops = n_ops / INT32_OPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- 1 ----

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tpubwa_torch.native import load_native
    from tpubwa_torch.ops import (extend_cuda, global_align_cuda,
                                  localsw_cuda, sa_sampled_cuda,
                                  smem_chain_cuda)

    builds = {"extend": lambda: extend_cuda.build("extend"),
              "extend_b": lambda: extend_cuda.build("extend_b"),
              "smem_chain": smem_chain_cuda.build,
              "global_align": global_align_cuda.build,
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
    print(f"[build] {len(builds)} kernel sources built in parallel in "
          f"{time.monotonic() - t0:.2f} s")
    for name, (report, dt) in done.items():
        print(f"[build] {name} ({KERNELS[name][0]}) built and loaded in "
              f"{dt:.2f} s")
        for line in report.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"[build]   ptxas: {line.strip()}")
        if name in ("extend_b", "sa_sampled"):      # redesigned in PR 7
            spills = [ln for ln in report.splitlines() if "spill" in ln]
            check(spills and all("0 bytes spill stores, 0 bytes spill loads"
                                 in ln for ln in spills),
                  f"{name}: ptxas reports no spills")
    t = time.monotonic()
    load_native()
    print(f"[build] native host library (tpubwa_torch/native/*.cpp, g++) "
          f"built and loaded in {time.monotonic() - t:.2f} s")


# ---------------------------------------------------------------- 2 ----

def random_jobs(seed: int, J: int, Q: int, T: int) -> tuple:
    """Extension jobs shaped like the main path's: the query is a mutated
    piece of the target (so bands, gaps and z-drops all occur), with
    empty lanes, N codes and a spread of bands and h0."""
    from tpubwa_torch.config import MemOptions

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
    from tpubwa_torch.config import MemOptions

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


def edge_sets() -> list:
    """(kernel, name, args, kw) of the adversarial job sets of utils.sim
    for K1, K1b and K4: qlen 0, 1, 31, 32, 33, Q; tlen 0, 1, T; w 0 and >=
    qlen; a z-drop that fires; endsc reached on row 0 and never; all-N
    query and target; ties for mj, te / qe and gscore; J = 1 and J a
    multiple of no group or block size; mostly dead lanes; scores beyond
    16 bits, and beyond 23 (K1b's two-reduction path)."""
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.utils.sim import extend_edge_jobs, localsw_edge_jobs

    opt = MemOptions()
    mat = opt.score_matrix()
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins)
    ekw = dict(gaps, zdrop=opt.zdrop, mat_max=opt.a)
    sets = []

    def ext(name, jobs, **over):
        q, ql, t, tl, w, h0, bonus = jobs
        for kern in ("extend", "extend_b"):
            sets.append((kern, f"edge jobs, {name}",
                         (q, ql, t, tl, mat, w, h0, bonus),
                         dict(ekw, **over)))

    def sw(name, jobs, m=mat, kw=gaps):
        q, ql, t, tl, minsc, endsc = jobs
        sets.append(("localsw", f"edge jobs, {name}",
                     (q, ql, t, tl, m, minsc, endsc), kw))

    full = extend_edge_jobs(1, Q_RAND, T_RAND)
    ext("zdrop 100", full)
    ext("zdrop 8", extend_edge_jobs(2, Q_RAND, T_RAND), zdrop=8)
    ext("Q=40 T=64", extend_edge_jobs(3, 40, 64))
    ext("one job", tuple(a[11:12] for a in full))
    dead = list(full)
    dead[1] = np.where(np.arange(len(dead[1])) % 37 == 0, dead[1], 0
                       ).astype(np.int32)
    ext("qlen zeroed on 36 of 37 lanes", dead)
    big = list(full)
    big[5] = big[5] * 5000
    ext("h0 x 5000 (scores beyond 16 bits)", big)
    big[5] = full[5] * 50000      # K1b's fused (H << 8 | j) key is refused
    ext("h0 x 50000 (scores beyond 23 bits)", big)
    ext("gaps 4+2 / 7+1, zdrop 20", extend_edge_jobs(4, Q_RAND, T_RAND),
        o_del=4, e_del=2, o_ins=7, e_ins=1, zdrop=20)

    for T in (1024, 256):
        sw(f"T={T}", localsw_edge_jobs(T, Q_SW, T))
    one = localsw_edge_jobs(5, Q_SW, 1024)
    sw("one job", tuple(a[13:14] for a in one))
    sw("Q=40 T=96", localsw_edge_jobs(6, 40, 96))
    k = list(one)
    k[4] = np.minimum(k[4], 1 << 20) * 1000
    k[5] = np.where(k[5] < 1 << 20, k[5] * 1000, k[5])
    sw("scores x 1000 (beyond 16 bits)", k, m=mat * 1000,
       kw={n: v * 1000 for n, v in gaps.items()})
    return sets


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


def _kernel_events(run) -> tuple[list, float]:
    """(the device-kernel events of `run` under torch.profiler, its wall
    seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(WORK, exist_ok=True)
    trace = os.path.join(WORK, "kernel_events.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"], wall


def _by_name(kern: list) -> dict:
    """Device microseconds and launches by kernel name, largest first."""
    tot: dict = {}
    for e in kern:
        us, n = tot.get(e["name"], (0.0, 0))
        tot[e["name"]] = (us + e["dur"], n + 1)
    return dict(sorted(tot.items(), key=lambda kv: -kv[1][0]))


def device_ms(fn, own: str) -> tuple[float, float, int] | None:
    """One call of wrapper `fn` on the card's own clock: (ms inside the
    kernels whose name contains `own`, ms inside all its kernels, how many
    kernels it launches), averaged over the calls the profiler traced.
    None where the profiler traced no launch of `own`: a window this short
    sometimes comes back empty, and on some machines every one does.  The
    split is a report beside the CUDA-event time, which is the number the
    checks and the kernels line use, so its absence fails nothing."""
    for reps in (5, 20, 80):
        kern, _ = _kernel_events(lambda: [fn() for _ in range(reps)])
        # a call launches `own` once; the profiler may drop some calls
        mine = [e["dur"] for e in kern if own in e["name"]]
        if mine:
            calls = len(mine)
            return (sum(mine) / calls / 1e3,
                    sum(e["dur"] for e in kern) / calls / 1e3,
                    len(kern) // calls)
        time.sleep(0.2)
    return None


def same_fields(what: str, got, want) -> int:
    """Holds every field of `got` to `want` (named tuples of tensors):
    same shape and no element differing; returns max |got - want|."""
    import torch

    err = 0
    for field, g, p in zip(want._fields, got, want):
        check(g.shape == p.shape, f"{what}, field {field}: shape")
        diff = int((g.to(torch.int64) - p.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        check(diff == 0, f"{what}, field {field} (max |diff| {diff})")
        err = max(err, diff)
    return err


def same_prep(name: str, a: tuple, kw: dict) -> int:
    """K1's prep kernel (band clamp, sort keys) against clamp_band_batch
    and job_keys on the jobs `a`; returns max |diff|."""
    from tpubwa_torch.ops.extend import clamp_band_batch
    from tpubwa_torch.ops.extend_cuda import job_keys, job_keys_core

    _, qlen, _, tlen, _, w, _, bonus = a
    Q, T = a[0].shape[1], a[2].shape[1]
    gaps = {k: v for k, v in kw.items() if k != "zdrop"}
    wc, keys = job_keys_core(qlen, tlen, w, bonus, Q, T, **gaps)
    want_wc = clamp_band_batch(w, qlen, gaps["mat_max"], gaps["o_del"],
                               gaps["e_del"], gaps["o_ins"], gaps["e_ins"],
                               bonus)
    want_keys = job_keys(qlen, tlen, want_wc, Q, T)
    err = 0
    for what, g, p in (("bands", wc, want_wc), ("keys", keys, want_keys)):
        diff = int((g.long() - p.long()).abs().max()) if g.numel() else 0
        check(diff == 0, f"extend prep {what} == plain on {name}")
        err = max(err, diff)
    return err


def compare(kernel: str, name: str, args: tuple, kw: dict) -> dict:
    """Kernel vs its plain version on the card, same inputs: exact
    equality on every field, and both times (CUDA events).  These
    launches are not the main path's: the counters are restored."""
    import torch

    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.localsw import localsw_batch

    plain = localsw_batch if kernel == "localsw" else _extend_core
    fn, = _counters()[kernel]
    n0 = fn.launches
    dev = torch.device("cuda")
    a = tuple(torch.as_tensor(x).to(dev) for x in args)
    got = fn(*a, **kw)
    stats: dict = {}
    want = plain(*a, **kw) if kernel == "localsw" else \
        plain(*a, **kw, stats=stats)
    torch.cuda.synchronize()
    err = same_fields(f"{kernel} == plain on {name}", got, want)
    if kernel == "extend":
        err = max(err, same_prep(name, a, kw))
    ms = _cuda_ms(lambda: fn(*a, **kw), reps=20)
    plain_ms = _cuda_ms(lambda: plain(*a, **kw), reps=2)
    fn.launches = n0
    J, Q = a[0].shape
    T = a[2].shape[1]
    if kernel == "localsw":
        # a job scans its rows up to the first one reaching endsc (that
        # row is then te), else all tlen of them; qlen cells a row
        qlen, tlen, endsc = a[1].clamp(0, Q), a[3].clamp(0, T), a[6]
        rows = torch.where(want.score >= endsc, want.te + 1, tlen)
        per_job = rows.to(torch.int64) * qlen
        cells = int(per_job.sum())
        ops = cells * OPS_SW_CELL
    else:
        per_job = stats["cells_per_job"]
        cells = stats["cells"]
        ops = cells * OPS_EXT_CELL
    pj = per_job.double()
    live = int((per_job > 0).sum())
    print(f"[{kernel}] {name}: cells a job: mean {float(pj.mean()):.1f}, "
          f"p99 {float(torch.quantile(pj, 0.99)):.0f}, max {int(pj.max())}; "
          f"{live} of {J} jobs visit a cell")
    moved = _nbytes(*(x for x in a if x.dim() > 0 and x.shape[0] == J),
                    *got)
    b = bound(moved, ops)
    with keep_launches():
        split = device_ms(lambda: fn(*a, **kw), KERNEL_FUNCS[kernel])
    on_card = (f"{KERNEL_FUNCS[kernel]} {split[0]:.4f} ms of {split[1]:.4f} "
               f"ms in the wrapper's {split[2]} device kernels" if split
               else f"{KERNEL_FUNCS[kernel]} not measured (the profiler "
               "traced none of its launches)")
    print(f"[{kernel}] {name}: J={J} Q={Q} T={T}: kernel == plain on all "
          f"{len(want)} fields (max |err| {err}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; {cells} cells visited, {moved} bytes: "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({100 * b['bound_ms'] / ms:.1f}% of it reached); on the card's "
          f"clock {on_card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)


def band_share(args: tuple, kw: dict) -> str:
    """How much of a row the clamped band covers on these jobs: the share
    of live jobs whose band (2w + 1 columns) holds the whole query, and
    the mean of min(2w + 1, qlen) / qlen (what band-relative columns would
    leave of a row)."""
    import torch

    from tpubwa_torch.ops.extend import clamp_band_batch

    _, qlen, _, tlen, _, w, _, bonus = (torch.as_tensor(x) for x in args)
    qlen = qlen.clamp(max=args[0].shape[1])
    wc = clamp_band_batch(w, qlen, kw["mat_max"], kw["o_del"], kw["e_del"],
                          kw["o_ins"], kw["e_ins"], bonus)
    live = (qlen > 0) & (tlen > 0)
    width = (2 * wc.to(torch.int64) + 1)[live]
    ql = qlen[live].to(torch.int64)
    if not ql.numel():
        return "no live job"
    return (f"2w+1 >= qlen on {100 * float((width >= ql).double().mean()):.1f}"
            f"% of {ql.numel()} live jobs, band / qlen mean "
            f"{float((torch.minimum(width, ql) / ql).mean()):.3f}")


# ------------------------------------------------------- 2: K2, K3 ----

def _timed(fn) -> tuple:
    """(result, ms) of one call, by CUDA events (no warm-up: for the
    plain versions, which take seconds)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


def first_batch(fq: str, n: int = BATCH) -> tuple:
    """(codes int32 [n, L], lens int32 [n]) of the first n reads of `fq`,
    padded as the pipeline pads them."""
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.io.fastq import stream_batches

    batch = next(iter(stream_batches(fq, n, MemOptions().max_read_len)))
    return (np.asarray(batch.codes, np.int32), np.asarray(batch.lens,
                                                          np.int32))


def _same_smems(tag: str, got, want) -> int:
    """Whole buffers equal in dtype, shape and every element; returns
    max |got - want|."""
    for field, g, p in zip(want._fields, got, want):
        check(g.dtype == p.dtype, f"K2 dtype, {tag}, field {field}")
    return same_fields(f"K2 == plain, {tag}", got, want)


def phase_k2(fixtures: dict, prefix: str = "k2",
             layouts: tuple = (False, True)) -> dict:
    """K2 against the plain chains on the first batch of each fixture
    ({"se": (fa, fq), "pe": (fa, fq1)}) in each layout of `layouts`
    (False: narrow, True: wide); returns each fixture's kernels-line entry
    (times and bound of the three rounds on its first batch, in the first
    layout) by name.  Every fixture but phase 4's random genome must reach
    the overflow path at the small caps."""
    import torch

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import DeviceIndex

    opt = MemOptions()
    dev = torch.device("cuda")
    msl, cap, r2_cap = opt.min_seed_len, opt.max_smems_per_read, 32
    entries = {}
    with keep_launches():
        for name, (fa, fq) in fixtures.items():
            idx = FMIndex.load(fa)
            codes, lens_h = first_batch(fq)
            q = torch.as_tensor(codes, device=dev)
            lens = torch.as_tensor(lens_h, device=dev)
            B = q.shape[0]
            G = 2 * B
            for wide in layouts:
                layout = "wide" if wide else "narrow"
                di = DeviceIndex.from_host(idx, dev, wide=wide, sa_stub=True)
                tag = f"{name} {layout}"
                steps = {r: torch.zeros(G if r == "r2" else B,
                                        dtype=torch.int32, device=dev)
                         for r in ("r1", "r2", "r3")}
                # round 2's lanes: wave 0 of the candidates round 1 gives
                _, src_tab, r1s, r1e, r1n, total = plain._smem_r1_prep(
                    di, q, lens, min_seed_len=msl, split_len=opt.split_len,
                    split_width=opt.split_width, out_cap=cap)
                lanes = plain._r2_lanes(src_tab, r1s, r1e, r1n, total, 0,
                                        out_cap=cap, G=G)
                calls = {
                    "r1": (k2.smem_round1_core, plain.smem_round1_chain,
                           (di, q, lens), dict(min_seed_len=msl)),
                    "r2": (k2.smem_through_core, plain.smem_through_chain,
                           (di, q, lens, *lanes), dict(min_seed_len=msl)),
                    "r3": (k2.smem_round3_core, plain.smem_round3_chain,
                           (di, q, lens),
                           dict(min_seed_len=msl,
                                max_mem_intv=opt.max_mem_intv)),
                }
                ms, plain_ms, emitted, ovf = {}, {}, {}, {}
                err = 0
                for r, (core, ref, args, kw) in calls.items():
                    full = r2_cap if r == "r2" else cap
                    for c in (full, 1 if r == "r2" else 2):
                        got = core(*args, **kw, cap=c, steps_out=steps[r])
                        want, t_plain = _timed(
                            lambda: ref(*args, **kw, cap=c))
                        err = max(err, _same_smems(f"{tag} {r} cap {c}",
                                                   got, want))
                        if c == full:
                            plain_ms[r] = t_plain
                            emitted[r] = int(got.n.sum())
                        else:
                            ovf[r] = int(got.overflow.sum())
                            # the repeat genome must reach the overflow
                            # path; a random one emits too little for it
                            check(ovf[r] > 0 or name == "se",
                                  f"{tag} {r} cap {c} overflows")
                    ms[r] = _cuda_ms(lambda: core(*args, **kw, cap=full),
                                     reps=20)
                n_steps = {r: int(v.sum()) for r, v in steps.items()}
                print(f"[{prefix}] {tag}: B={B} L={q.shape[1]}, {total} "
                      f"round-2 candidates ({min(total, G)} in wave 0 of "
                      f"G={G}): "
                      "rounds 1, 2, 3 == plain on whole buffers at caps "
                      f"{cap}/{r2_cap}/{cap} (emitted {emitted}) and at "
                      f"2/1/2 (lanes overflowing {ovf}); kernel "
                      + " ".join(f"{r} {ms[r]:.3f}" for r in ms)
                      + " ms, plain "
                      + " ".join(f"{r} {plain_ms[r]:.1f}" for r in ms)
                      + f" ms; extension steps {n_steps}")
                # a launch ends with its longest lane: ms / max steps is
                # the time of one step on that chain, and their product
                # the floor of the launch
                for r, v in steps.items():
                    d = v.double()
                    mx = int(v.max())
                    print(f"[{prefix}] {tag} {r}: steps a lane: mean "
                          f"{float(d.mean()):.1f}, p99 "
                          f"{float(torch.quantile(d, 0.99)):.0f}, max {mx}; "
                          f"{ms[r]:.3f} ms / {mx} steps = "
                          f"{1e3 * ms[r] / max(mx, 1):.3f} us a step on the "
                          "longest chain")
                if wide == layouts[0]:
                    # each step reads two checkpoint rows; what the table
                    # holds is read at most once, the rest is reuse
                    row_b = di.cp.element_size() * 8
                    total_steps = sum(n_steps.values())
                    item = di.cp.element_size()
                    moved = (min(_nbytes(di.cp), 2 * row_b * total_steps)
                             + 3 * _nbytes(q, lens) + _nbytes(*lanes)
                             + (2 * B * cap + G * r2_cap) * 5 * item
                             + (2 * B + G) * 5)
                    b = bound(moved, total_steps * OPS_CHAIN_STEP)
                    print(f"[{prefix}] bound of the three rounds ({tag}): "
                          f"{total_steps} steps x {OPS_CHAIN_STEP} ops, "
                          f"{moved} bytes: {b['bound_ms']:.4f} ms by "
                          f"{b['bound_by']}; as dependent gathers, "
                          f"{2 * total_steps} rows of {row_b} bytes")
                    entries[name] = dict(
                        max_abs_err=err, ms=sum(ms.values()),
                        plain_ms=sum(plain_ms.values()), **b)
    return entries


def gather_rate(idx, tag: str = "gather", beyond_l2: bool = False) -> None:
    """The card's random-gather rate on the checkpoint table (rows of 32
    bytes at random addresses, the access of K2 and K5) and the time of
    one dependent gather from it.  ``beyond_l2`` adds the dependent
    gather over the wide layout's checkpoint table and over the SA, each
    read as rows of 32 bytes: tables that do not fit the L2 cache."""
    import torch

    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.utils.gather_latency import measure

    dev = torch.device("cuda")
    di = DeviceIndex.from_host(idx, dev, sa_stub=not beyond_l2)
    cp = di.cp
    n = 1 << 24
    rows = torch.randint(0, cp.shape[0], (n,), device=dev)
    ms = _cuda_ms(lambda: cp[rows], reps=5)
    print(f"[{tag}] {n} random rows of {cp.shape[1] * cp.element_size()} "
          f"bytes from a {_nbytes(cp)}-byte table (independent, torch "
          f"index): {ms:.3f} ms = {n / ms / 1e6:.2f} G rows/s")
    # the other end: one DEPENDENT gather after another, the floor under
    # a step of K2's chains (a probe kernel, no part of the aligner)
    tables = {"checkpoints": cp}
    if beyond_l2:
        wide = DeviceIndex.from_host(idx, dev, wide=True, sa_stub=True).cp
        tables["wide checkpoints"] = wide.view(torch.int32).view(-1, 8)
        sa = di.sa[:di.sa.numel() // 8 * 8]
        tables["SA"] = sa.view(-1, 8)
    for name, table in tables.items():
        for r in measure(table):
            print(f"[{tag}] dependent loads over {r['rows']} rows "
                  f"({r['table_bytes']} bytes) of the {name}, {r['what']}: "
                  f"{r['us_per_step']:.3f} us = {r['cycles_per_step']:.0f} "
                  "cycles a step")


def _ga_cells(qlen, tlen, w) -> int:
    """Band cells of the fill of GA lanes."""
    qlen, tlen, w = (np.asarray(a, np.int64) for a in (qlen, tlen, w))
    cells = 0
    for i in range(int(tlen.max()) if tlen.size else 0):
        width = np.minimum(qlen, i + w + 1) - np.maximum(i - w, 0)
        cells += int(np.where(i < tlen, np.maximum(width, 0), 0).sum())
    return cells


def _ga_steps(pack, dev_args: tuple, gaps: dict) -> int:
    """Traceback steps these lanes really take: the segment lengths of the
    plain version's pack, and for the lanes it leaves empty (nseg > GA_K)
    the entries of the plain version's step rows that are not the end
    mark."""
    import torch

    from tpubwa_torch.align.flatsam import GA_K
    from tpubwa_torch.ops.global_align import global_align_cigar_batch

    qD, tD, rows, qlen, tlen, w, mat = dev_args
    steps = int((pack[:, 2:].to(torch.int32) >> 2).sum())
    over = pack[:, 1] > GA_K
    if bool(over.any()):
        r = rows[over]
        res = global_align_cigar_batch(
            qD[r].to(torch.int32), qlen[over], tD[r].to(torch.int32),
            tlen[over], mat, w[over], **gaps)
        steps += int((res.steps != 3).sum())
    return steps


def compare_ga(name: str, dev_args: tuple, gaps: dict) -> dict:
    """K3's pack against _ga_rows_plain on lanes (qD, tD, rows, qlen,
    tlen, w, mat) already on the card: exact, both times, the bound."""
    import torch

    from tpubwa_torch.align.flatsam import GA_K, _ga_rows, _ga_rows_plain

    with keep_launches():
        got = _ga_rows(*dev_args, **gaps)
        want, plain_ms = _timed(
            lambda: _ga_rows_plain(*dev_args, **gaps, ga_k=GA_K))
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"K3 pack shape and dtype, {name}")
        diff = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) \
            if got.numel() else 0
        check(diff == 0, f"K3 pack == plain on {name} (max |diff| {diff})")
        ms = _cuda_ms(lambda: _ga_rows(*dev_args, **gaps), reps=10)
    qlen, tlen, w = (a.cpu().numpy() for a in dev_args[3:6])
    cells = _ga_cells(qlen, tlen, w)
    steps = _ga_steps(want, dev_args, gaps)
    M = int(qlen.size)
    moved = int(qlen.sum() + tlen.sum()) + M * (8 + 12) + _nbytes(got)
    b = bound(moved, cells * OPS_GA_CELL + steps * OPS_GA_STEP)
    nseg = want[:, 1]
    print(f"[k3] {name}: M={M} lanes of Q={dev_args[0].shape[1]} "
          f"T={dev_args[1].shape[1]}: pack == plain ({int((nseg > 1).sum())} "
          f"gapped, {int((nseg > GA_K).sum())} with nseg > {GA_K}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms; {cells} band cells, "
          f"{steps} traceback steps, "
          f"{moved} bytes: bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms, **b)


def phase_k3() -> dict:
    """K3 on synthetic lanes: the pack on 8192 of them, the executor's
    step rows (its second output) on 512, against the plain versions."""
    import torch

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops.global_align import global_align_cigar_batch
    from tpubwa_torch.ops.global_align_cuda import global_align_cigar_core
    from tpubwa_torch.utils.sim import ga_lanes

    opt = MemOptions()
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins)
    dev = torch.device("cuda")
    n = BATCH + 9
    qD, tD, qlen, tlen, w = ga_lanes(5, n, w0=opt.w)
    rows = np.random.default_rng(0).permutation(n)[:BATCH].astype(np.int64)
    check((tlen[rows] == 1).any() and (qlen[rows] == 1).any()
          and (w[rows] == 4 * opt.w).any(),
          "synthetic lanes hold tlen 1, qlen 1 and w at its cap")
    res = compare_ga("synthetic lanes", tuple(
        torch.as_tensor(a, device=dev) for a in (
            qD, tD, rows, qlen[rows], tlen[rows], w[rows],
            opt.score_matrix())), gaps)
    sub = rows[:512]
    args = [torch.as_tensor(a, device=dev) for a in (
        qD[sub].astype(np.int32), qlen[sub], tD[sub].astype(np.int32),
        tlen[sub], opt.score_matrix(), w[sub])]
    with keep_launches():
        got = global_align_cigar_core(*args, **gaps)
        want = global_align_cigar_batch(*args, **gaps)
        torch.cuda.synchronize()
    check(torch.equal(got.score, want.score)
          and torch.equal(got.steps, want.steps),
          "K3 step rows and scores == plain on 512 synthetic lanes")
    print("[k3] executor entry: 512 lanes, scores and whole step rows == "
          "plain")
    return res



def ga_calls(tag: str, calls: list) -> dict:
    """Every _ga_rows call of a counted run against the plain version, one
    line a call: which batch (calls on one window buffer) and which
    band-doubling round of it, lanes, band cells, widest band, kernel ms.
    Returns the first call's entry (the first batch's non-exact lanes)."""
    first = None
    batch, rnd, last = 0, 0, (None, 0)
    for args, kw, buf in calls:
        # a later round of a batch runs on the same window buffer and on a
        # subset of the lanes
        m = args[2].shape[0]
        batch, rnd = ((batch, rnd + 1) if buf == last[0] and m <= last[1]
                      else (batch + 1, 1))
        last = (buf, m)
        w = args[5]
        r = compare_ga(f"{tag} batch {batch} round {rnd}: widest band "
                       f"w={int(w.max())} (mean {float(w.float().mean()):.1f})",
                       args, kw)
        first = first or r
        first["max_abs_err"] = max(first["max_abs_err"], r["max_abs_err"])
    return first


def phase_k2_edge() -> dict:
    """K2 on the adversarial reads of utils.sim, narrow and wide, at caps
    64 and 1: whole buffers equal to the plain chains'."""
    import torch

    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.utils import sim

    dev = torch.device("cuda")
    codes = sim.smem_edge_reference(5)
    idx = FMIndex.build([Contig("c1", len(codes), 0)], codes)
    qh, lh = sim.smem_edge_reads(6, codes)
    q, lens = torch.as_tensor(qh, device=dev), torch.as_tensor(lh, device=dev)
    rd, mid, thr, act = (torch.as_tensor(a, device=dev)
                         for a in sim.smem_edge_round2(7, lh))
    err = 0
    with keep_launches():
        for wide in (False, True):
            di = DeviceIndex.from_host(idx, dev, wide=wide)
            lanes = (rd, mid, thr.to(di.L2.dtype), act)
            for cap in (64, 1):
                steps = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
                for r, core, ref, args, kw in (
                        ("r1", k2.smem_round1_core, plain.smem_round1_chain,
                         (di, q, lens), {}),
                        ("r2", k2.smem_through_core, plain.smem_through_chain,
                         (di, q, lens, *lanes), {}),
                        ("r3", k2.smem_round3_core, plain.smem_round3_chain,
                         (di, q, lens), dict(max_mem_intv=20)),
                        ("r3 max_mem_intv 3", k2.smem_round3_core,
                         plain.smem_round3_chain, (di, q, lens),
                         dict(max_mem_intv=3))):
                    got = core(*args, min_seed_len=19, cap=cap, **kw,
                               **(dict(steps_out=steps) if r == "r1" else {}))
                    want = ref(*args, min_seed_len=19, cap=cap, **kw)
                    tag = (f"edge reads {'wide' if wide else 'narrow'} {r} "
                           f"cap {cap}")
                    err = max(err, _same_smems(tag, got, want))
                    check(bool(got.overflow.any()) == (cap == 1),
                          f"{tag}: lanes overflow at cap 1 only")
            st = steps.cpu().numpy()
            short = np.isin(np.arange(st.size) % 8, (1, 2, 3))
            check(st[0::8].min() >= 10 * np.median(st[short]),
                  "the long chain of a group of four lanes takes ten times "
                  "the steps of the short ones")
    print(f"[k2] edge reads: B={q.shape[0]} G={rd.shape[0]} L={q.shape[1]}, "
          "rounds 1, 2, 3 == plain on whole buffers, narrow and wide, caps "
          f"64 and 1; round-1 steps a lane: long reads >= {st[0::8].min()}, "
          f"short reads median {int(np.median(st[short]))}")
    return dict(max_abs_err=err)


def phase_k3_edge() -> dict:
    """K3 on the adversarial lanes of utils.sim at the three window shapes
    (the second launch takes lanes at 192x256 and 320x512, none at
    64x128): the pack, the step rows, and one lane alone."""
    import torch

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops.global_align import global_align_cigar_batch
    from tpubwa_torch.ops.global_align_cuda import global_align_cigar_core
    from tpubwa_torch.utils.sim import ga_edge_lanes

    opt = MemOptions()
    mat = opt.score_matrix()
    dev = torch.device("cuda")
    err = 0
    for Q, T in ((192, 256), (64, 128), (320, 512)):
        for gi, gaps in enumerate((
                dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                     e_ins=opt.e_ins),
                dict(o_del=4, e_del=2, o_ins=7, e_ins=1))):
            qD, tD, rows, qlen, tlen, w = ga_edge_lanes(1 + gi, Q, T)
            d = tuple(torch.as_tensor(a, device=dev)
                      for a in (qD, tD, rows, qlen, tlen, w, mat))
            r = compare_ga(f"edge lanes, gaps {gaps['o_del']}+"
                           f"{gaps['e_del']} / {gaps['o_ins']}+"
                           f"{gaps['e_ins']}", d, gaps)
            one = d[:2] + tuple(a[17:18] for a in d[2:6]) + d[6:]
            r1 = compare_ga("edge lanes, one lane", one, gaps)
            err = max(err, r["max_abs_err"], r1["max_abs_err"])
            args = [torch.as_tensor(a, device=dev) for a in (
                qD[rows].astype(np.int32), qlen, tD[rows].astype(np.int32),
                tlen, mat, w)]
            with keep_launches():
                got = global_align_cigar_core(*args, **gaps)
                want = global_align_cigar_batch(*args, **gaps)
                torch.cuda.synchronize()
            check(torch.equal(got.score, want.score)
                  and torch.equal(got.steps, want.steps),
                  f"K3 step rows and scores == plain on edge lanes {Q}x{T}")
    print("[k3] edge lanes: packs, scores and whole step rows == plain at "
          "192x256, 64x128 and 320x512, two gap sets")
    return dict(max_abs_err=err)



# ---------------------------------------------------------------- 3 ----

def _strip_pg(sam: str) -> str:
    """Without the @PG line, which carries the command line."""
    return "".join(ln for ln in sam.splitlines(keepends=True)
                   if not ln.startswith("@PG"))


def phase_golden(device: str = "cuda") -> None:
    from tpubwa_torch.align.pipeline import align_fastq
    from tpubwa_torch.utils.sim import golden_fixture

    d = os.path.join(WORK, "golden")
    os.makedirs(d, exist_ok=True)
    ref, se_fq, fq1, fq2 = golden_fixture(d)
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
        check(n["smem_chain"] > 0 and n["global_align"] > 0,
              f"golden {kind} launched K2 and K3")
        print(f"[golden] tests/golden/{kind}.sam reproduced byte for byte on "
              f"{device}, layout {layout} ({len(got)} bytes, "
              f"{time.monotonic() - t:.1f} s; launches {n})")


# ---------------------------------------------------------------- 4 ----

def capture_first(module, attr: str, captured: list, limit: int = 1):
    """Context manager: module.attr runs as it is, and the arguments of
    its first `limit` calls are kept (tensors cloned) in `captured`, each
    with the address of its first argument as a third entry (calls on one
    buffer belong together)."""
    import contextlib

    import torch

    fn = getattr(module, attr)

    def capturing(*args, **kw):
        if len(captured) < limit:
            captured.append((tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in args), dict(kw),
                             args[0].data_ptr() if torch.is_tensor(args[0])
                             else None))
        return fn(*args, **kw)

    @contextlib.contextmanager
    def cm():
        setattr(module, attr, capturing)
        try:
            yield
        finally:
            setattr(module, attr, fn)

    return cm()


def wave_capture(captured: dict):
    """K1's wrapper, keeping (tensors cloned) the core inputs of the first
    left and the first right wave of a run in `captured`, each with its
    retry launch (whose lanes are mostly dead)."""
    import torch

    from tpubwa_torch.ops.extend_cuda import extend_core

    def capturing_core(*args, **kw):
        # the caller's caller is extend_jobs_left / extend_jobs_right
        side = sys._getframe(2).f_code.co_name.rsplit("_", 1)[-1]
        if side in ("left", "right"):
            key = side if side not in captured else f"{side} retry"
            if key not in captured:
                captured[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args), dict(kw))
        return extend_core(*args, **kw)

    return capturing_core


def profiled_pass(tag: str, run, history: str = "", top: int = 6) -> None:
    """One pass (`run`) under torch.profiler: the number of device
    kernels, the device time and its share of the pass, the device time by
    kernel, and the totals of the port's own kernels."""
    for _ in range(3):      # a trace sometimes comes back with no events
        kern, wall = _kernel_events(run)
        if kern:
            break
    check(len(kern) > 0, "the profiler traced device kernels")
    dev_s = sum(e["dur"] for e in kern) / 1e6
    print(f"[{tag}] profiled pass: {len(kern)} device kernels, "
          f"{dev_s:.3f} s of device time in {wall:.2f} s = "
          f"{100 * dev_s / wall:.1f}% busy{history}")
    by_name = _by_name(kern)
    for name, (us, n) in list(by_name.items())[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms in {n:5d} launches  "
              f"{name[:80]}")
    own = ("extend_kernel", "class_bounds_kernel", "extend_b_kernel",
           "localsw_kernel", "global_align_kernel", "round1_kernel",
           "round2_kernel", "round3_kernel", "sa_sampled_kernel")
    print(f"[{tag}] the port's kernels in that pass: " + "; ".join(
        f"{o} {sum(us for nm, (us, _) in by_name.items() if o in nm) / 1e3:.3f}"
        f" ms / {sum(n for nm, (_, n) in by_name.items() if o in nm)}"
        for o in own if any(o in nm for nm in by_name)))


def se_fixture() -> tuple[str, str]:
    """bench.py's SE fixture (tools.bench.ensure_fixture: random genome,
    seed 42; reads seed 7), built in the checkout's build directory."""
    from tpubwa_torch.tools.bench import ensure_fixture

    t = time.monotonic()
    fa, fq, _ = ensure_fixture(REF_MB, N_READS, False, "random", WORK)
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


def phase_se(fa: str, fq: str, device: str = "cuda") -> dict:
    """Returns the captured core inputs {"left": (args, kw), "right":
    (args, kw)} and every _ga_rows call's of the counted run, its
    launches, and the fixture, aligner and SAM body for phases 7-9."""
    from tpubwa_torch.align import flatsam
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops import global_align_cuda
    from tpubwa_torch.ops.extend_cuda import extend_core

    idx = FMIndex.load(fa)
    aligner = Aligner(idx, MemOptions(batch_reads=BATCH), device=device)

    captured: dict = {}
    aligner.ext_core = wave_capture(captured)
    ga_captured: list = []
    out = io.StringIO()
    with capture_first(flatsam, "_ga_rows", ga_captured, limit=64):
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
    check(launches["smem_chain"] > 0, "the SE path launched K2 (SMEM "
          "chains)")
    check(launches["global_align"] > 0, "the SE path launched K3 (global "
          "alignment)")
    check(len(ga_captured) == global_align_cuda.ga_pack.launches > 0,
          "every _ga_rows call of the run captured")
    check(set(captured) == {"left", "left retry", "right", "right retry"},
          "left and right core inputs captured, each with its retry launch")
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
    profiled_pass("se", lambda: _timed_se(aligner, fq),
                  history=" (the same pass before K2 and K3: 637,745 "
                  "kernels, 1.081 s in 18.74 s = 5.8%)")
    return dict(captured=captured, ga=ga_captured, launches=launches,
                fa=fa, fq=fq, idx=idx, aligner=aligner, body=body)


# ---------------------------------------------------------------- 5 ----

def pe_fixture() -> tuple[str, str, str]:
    """bench.py's PE chr21-style fixture (tools.bench.ensure_fixture with
    pe and style chr21: bench.py's TPUBWA_BENCH_PE=1
    TPUBWA_BENCH_STYLE=chr21), built in the checkout's build directory."""
    from tpubwa_torch.tools.bench import ensure_fixture

    t = time.monotonic()
    fa, fq1, fq2 = ensure_fixture(REF_MB, 2 * N_PAIRS, True, "chr21", WORK)
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


def phase_pe(pe_files: tuple, device: str = "cuda") -> tuple:
    """Returns (launches of the counted layout-t run, launches of the
    layout-b pass, the first captured mate-rescue round (args, kw), the
    first captured _ga_rows call (args, kw))."""
    from tpubwa_torch.align import flatsam, pair
    from tpubwa_torch.align.pipeline import EXT_CORES, Aligner
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops import global_align_cuda

    fa, fq1, fq2 = pe_files
    idx = FMIndex.load(fa)
    aligner = Aligner(idx, MemOptions(batch_reads=BATCH), device=device)
    captured: list = []
    ga_captured: list = []
    out = io.StringIO()
    with capture_first(pair, "localsw_core", captured), \
            capture_first(flatsam, "_ga_rows", ga_captured, limit=64):
        _sync(device)
        reset_launches()
        t = time.monotonic()
        rc = pair.align_pe_fastq(aligner, fq1, fq2, out)
        _sync(device)
        cold = time.monotonic() - t
        launches = read_launches()
    check(rc == 0, "PE run exits 0")
    print(f"[pe] counted run (layout t): {2 * N_PAIRS} reads in "
          f"{cold:.2f} s (cold); launches {launches}")
    check(launches["extend"] > 0, "the PE path launched K1")
    check(launches["localsw"] > 0, "the PE path launched K4 (mate rescue)")
    check(launches["smem_chain"] > 0, "the PE path launched K2 (SMEM "
          "chains)")
    check(launches["global_align"] > 0, "the PE path launched K3 (global "
          "alignment)")
    check(len(captured) == 1, "first mate-rescue round captured")
    check(len(ga_captured) == global_align_cuda.ga_pack.launches > 0,
          "every _ga_rows call of the run captured")
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
    aligner.ext_core = EXT_CORES["t"]
    with keep_launches():
        profiled_pass("pe", lambda: check(pair.align_pe_fastq(
            aligner, fq1, fq2, io.StringIO()) == 0,
            "profiled PE pass exits 0"), top=12)
    return launches, b_launches, captured[0][:2], ga_captured


# ---------------------------------------------------------------- 6 ----

def phase_ablation() -> dict:
    """scripts/ablate_kernel_r5.py's seven variants on K1b at its shapes:
    B=4096, Q=192, T=256, target = copy of the query, w=100, h0=1."""
    import torch

    from tpubwa_torch.config import MemOptions
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
    extend_b_variant.launches = 0
    got = extend_b_variant("full", *args, **kw)
    want = _extend_core(*args, **kw)
    torch.cuda.synchronize()
    err = same_fields("ablation full variant == plain", got, want)
    times = {v: _cuda_ms(lambda v=v: extend_b_variant(v, *args, **kw),
                         reps=10) for v in VARIANTS}
    stats: dict = {}
    plain_ms = _cuda_ms(lambda: _extend_core(*args, **kw, stats=stats),
                        reps=1)
    b = bound(_nbytes(*(x for x in args if x.shape[0] == B), *got),
              stats["cells"] * OPS_EXT_CELL)
    print("[ablate] K1b variants, B=4096 Q=192 T=256 (full == plain): "
          + "  ".join(f"{v} {ms:.3f} ms" for v, ms in times.items())
          + f"; plain {plain_ms:.1f} ms; {stats['cells']} cells: bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}; "
          f"{extend_b_variant.launches} launches")
    return dict(max_abs_err=err, ms=times["full"], plain_ms=plain_ms,
                launches=extend_b_variant.launches, **b)


# ---------------------------------------------------------------- 7 ----

def k5_walks(sa, shift: int) -> str:
    """LF steps a row at 2^shift (mean, max) and the share of a
    thread-per-row warp's lane-turns that do work: every row's probes
    (steps + 1) over 32 x the longest walk of each 32 consecutive rows."""
    import torch

    probes = (sa % (1 << shift)).to(torch.int64) + 1
    pad = (-probes.numel()) % 32
    longest = torch.cat([probes, probes.new_zeros(pad)]).view(-1, 32).amax(1)
    eff = float(probes.sum()) / (32 * float(longest.sum()))
    return (f"LF steps a row mean {float(probes.double().mean()) - 1:.3f}, "
            f"max {int(probes.max()) - 1}; a thread a row would keep "
            f"{100 * eff:.1f}% of its lane-turns busy")


def k5_bound(di, ss, rows, got, shift: int, live: int) -> dict:
    """K5's bound on `live` rows whose results are `got`: the steps these
    walks take (position mod 2^shift each, plus one probe) x OPS_LF_STEP,
    and the bytes of the live rows in, every row out, and the table rows
    the walks touch (each table read at most once)."""
    import torch

    n_steps = int((got[:live].to(torch.int64) % (1 << shift)).sum())
    tables = _nbytes(di.cp, ss.blocks, ss.vals)
    row_b = (di.cp.shape[1] + ss.blocks.shape[1]) * di.cp.element_size()
    moved = (_nbytes(rows[:live]) + _nbytes(rows)
             + min(tables, (n_steps + live) * row_b))
    return dict(steps=n_steps, moved=moved,
                **bound(moved, (n_steps + live) * OPS_LF_STEP))


def phase_k5(idx) -> dict:
    """K5 against its plain version and the full SA on every row of
    `idx`, narrow and wide, shifts 2, 4 and 5, and on the edge rows of
    utils.sim at shifts 0, 1 and 5; times at shift 5, with the walks'
    steps and what one row a thread would waste of them."""
    import torch

    from tpubwa_torch.ops.fm import (DeviceIndex, build_sampled_sa,
                                     sa_lookup_sampled)
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
    from tpubwa_torch.utils.sim import sa_edge_rows

    k5 = sa_lookup_sampled_core
    n0 = k5.launches
    dev = torch.device("cuda")
    sa = torch.as_tensor(idx.sa, device=dev)               # int64 [N+1]
    n = sa.numel()
    err, times = 0, {}
    for wide in (False, True):
        layout = "wide" if wide else "narrow"
        dt = torch.int64 if wide else torch.int32
        di = DeviceIndex.from_host(idx, dev, wide=wide, sa_stub=True)
        rows = torch.arange(n, device=dev, dtype=dt)
        for shift in (0, 1, 2, 4, 5):
            ss = build_sampled_sa(None, shift, wide, idx=idx, device=dev)
            edge = sa_edge_rows(idx, shift)
            er = torch.as_tensor(edge, device=dev).to(dt)
            got = k5(di, ss, er, shift)
            want = sa_lookup_sampled(di, ss, er, shift)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(
                got.to(torch.int64).cpu(), torch.as_tensor(idx.sa[edge])),
                f"K5 == plain == full SA on the {edge.size} edge rows "
                f"({layout}, shift {shift})")
            if shift < 2:
                print(f"[k5] {layout} shift {shift}: {edge.size} edge rows "
                      "== plain == full SA")
                continue
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
            line = (f"[k5] {layout} shift {shift}: {n} rows and "
                    f"{edge.size} edge rows == plain == full SA")
            if shift == 5:
                ms = _cuda_ms(lambda: k5(di, ss, rows, shift), reps=10)
                plain_ms = _cuda_ms(
                    lambda: sa_lookup_sampled(di, ss, rows, shift), reps=2)
                b = k5_bound(di, ss, rows, got, shift, n)
                times[layout] = {k: b[k] for k in ("bound_ms", "bound_by",
                                                   "library_ms")}
                times[layout].update(ms=ms, plain_ms=plain_ms)
                line += (f"; kernel {ms:.3f} ms ({k5_card(di, ss, rows, shift)}"
                         f"), plain {plain_ms:.3f} ms; {k5_walks(sa, shift)}; "
                         f"{b['steps']} LF steps, {b['moved']} bytes: bound "
                         f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
            print(line)
    k5.launches = n0
    return dict(max_abs_err=err, **times["narrow"])


def k5_card(di, ss, rows, shift: int, **kw) -> str:
    """K5's time on the card's clock (torch.profiler) for one call."""
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    with keep_launches():
        split = device_ms(lambda: sa_lookup_sampled_core(
            di, ss, rows, shift, **kw), "sa_sampled_kernel")
    return (f"{split[0]:.4f} ms on the card's clock" if split
            else "card's clock not measured")


def k5_calls(calls: list, shift: int, tag: str = "8a") -> None:
    """Every K5 call of a counted run (seed_rows' lookups, a call a
    batch), one line a call: rows, live rows, kernel and plain ms, the
    bound on the live rows' walks; exact against the plain version."""
    import torch

    from tpubwa_torch.ops.fm import sa_lookup_sampled
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    with keep_launches():
        for i, (args, kw, _) in enumerate(calls):
            di, ss, rows, sh = args
            check(sh == shift, "the run's shift")
            got = sa_lookup_sampled_core(*args, **kw)
            want = sa_lookup_sampled(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K5 == plain on call {i + 1}")
            live = int(kw["n_live"]) if kw.get("n_live") is not None \
                else rows.numel()
            ms = _cuda_ms(lambda: sa_lookup_sampled_core(*args, **kw),
                          reps=10)
            _, plain_ms = _timed(lambda: sa_lookup_sampled(*args, **kw))
            b = k5_bound(di, ss, rows, got, shift, live)
            # every row of the buffer, as the first design walked them
            every_ms = _cuda_ms(lambda: sa_lookup_sampled_core(
                di, ss, rows, sh), reps=10)
            print(f"[{tag}] K5 call {i + 1}: {rows.numel()} rows, {live} "
                  f"live; kernel {ms:.4f} ms, {k5_card(*args, **kw)}; plain "
                  f"{plain_ms:.3f} ms; {b['steps']} LF steps: bound "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                  f"({100 * b['bound_ms'] / ms:.1f}% of it reached); every "
                  f"row: {every_ms:.4f} ms, {k5_card(di, ss, rows, sh)}")


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

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.align import pair
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.ops import seeds
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa

    dev = torch.device("cuda")
    idx, fq, body = se["idx"], se["fq"], se["body"]

    # (a) sampled SA, bwa's default interval of 32
    al = Aligner(idx, MemOptions(batch_reads=BATCH, sa_sample_shift=5),
                 device=dev)
    k5_captured: list = []
    with capture_first(seeds, "sa_lookup_sampled_core", k5_captured,
                       limit=64):
        _sync()
        reset_launches()
        text, cold = _timed_se(al, fq)
        launches = read_launches()
    check(len(k5_captured) == launches["sa_sampled"],
          "every K5 call of the --sa-shift 5 run captured")
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
    k5_calls(k5_captured, 5)

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


# --------------------------------------------------------------- 10 ----

MESH = 4               # preset v5e-4: 4 shards, batch 32768
MESH_BATCH = 32768


def _pass(al, run) -> tuple[str, float, dict]:
    """(SAM text, seconds, launches) of one counted pass ``run(al, out)``;
    the launches also hold K2's by round ("k2 rounds")."""
    from tpubwa_torch.ops import smem_chain_cuda as k2

    out = io.StringIO()
    _sync()
    reset_launches()
    t = time.monotonic()
    run(al, out)
    _sync()
    dt = time.monotonic() - t
    n = read_launches()
    n["k2 rounds"] = tuple(f.launches for f in (
        k2.smem_round1_core, k2.smem_through_core, k2.smem_round3_core))
    return out.getvalue(), dt, n


def _cli(tag: str, args: list) -> tuple:
    """Start `python -m tpubwa_torch.cli mem ARGS` with its output and
    errors going to files of WORK; returns (process, its out and err
    paths)."""
    paths = [os.path.join(WORK, f"cli_{tag}.{k}") for k in ("sam", "err")]
    with open(paths[0], "w") as out, open(paths[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpubwa_torch.cli", "mem", *args],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
            stderr=err, text=True)
    return proc, paths


def _cli_result(started: tuple) -> tuple[str, str, int]:
    """(output, errors, exit code) of a `_cli` process, once it ends."""
    proc, paths = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    texts = []
    for path in paths:
        with open(path) as f:
            texts.append(f.read())
    return texts[0], texts[1], rc


def _launch_line(n: dict) -> str:
    return (f"K2 {n['smem_chain']} (rounds 1/2/3: "
            f"{'/'.join(map(str, n['k2 rounds']))}), K1 {n['extend']}, K3 "
            f"{n['global_align']}, K4 {n['localsw']}, K5 {n['sa_sampled']}")


def phase_mesh(se: dict, pe_files: tuple) -> None:
    """The device mesh (preset v5e-4: 4 shards, batch 32768) on
    ["cuda:0"] * 4 beside one device at the same batch."""
    import dataclasses

    import torch

    from tpubwa_torch.align import pair
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops.fm import DeviceIndex, ShardedSA

    t0 = time.monotonic()
    ref = os.path.join(WORK, "golden", "golden_ref.fa")
    gfq = os.path.join(WORK, "golden", "se.fq")
    mesh_dev = ",".join(["cuda:0"] * MESH)
    # (f) and (g) are separate processes: start them now
    n_cards = torch.cuda.device_count()
    clis = {"f mesh": _cli("f_mesh", ["--preset", "v5e-4", "--device",
                                      mesh_dev, ref, gfq]),
            "f one": _cli("f_one", ["--batch", str(MESH_BATCH), "--device",
                                    "cuda:0", ref, gfq]),
            "g": _cli("g", ["--preset", "v5e-4", "--device", "cuda", ref,
                            gfq])}

    opt = MemOptions.preset("v5e-4")
    check(opt.batch_reads == MESH_BATCH and opt.mesh_shape == (MESH,),
          "preset v5e-4 is a mesh of 4 at batch 32768")
    one_opt = MemOptions(batch_reads=MESH_BATCH)
    mesh = ["cuda:0"] * MESH
    se_run = (lambda al, out: run_se_pipeline(al, se["fq"], out))
    fa, fq1, fq2 = pe_files
    pidx = FMIndex.load(fa)

    def pe_run(al, out):
        check(pair.align_pe_fastq(al, fq1, fq2, out) == 0, "PE exits 0")

    # (a) SE, and (b) PE: 4 shards beside 1 at the same batch; after a
    # counted cold pass each, warm passes in turns: 1, 4, 4, 1, 1, 4
    for leg, idx, run, n_reads in (("a", se["idx"], se_run, N_READS),
                                   ("b", pidx, pe_run, 2 * N_PAIRS)):
        als = {1: Aligner(idx, one_opt, device="cuda:0"),
               MESH: Aligner(idx, opt, device=mesh)}
        got = {}
        for k, al in als.items():
            body, cold, n = _pass(al, run)
            got[k] = (body, n)
            al.timers = type(al.timers)()
            print(f"[10{leg}] {k} shard(s) on {al.mesh.devices[0]}: "
                  f"{n_reads} reads, cold {cold:.2f} s; launches "
                  f"{_launch_line(n)}")
        warm = {1: [], MESH: []}
        for k in (1, MESH, MESH, 1, 1, MESH):
            body, dt, _ = _pass(als[k], run)
            check(body == got[k][0], f"10{leg} {k} shard(s): warm body == "
                  "cold")
            warm[k].append(dt)
        for k, al in als.items():
            rates = [n_reads / dt for dt in warm[k]]
            print(f"[10{leg}] {k} shard(s), warm (batch {MESH_BATCH}): "
                  f"{', '.join(f'{r:.1f}' for r in rates)} reads/s, median "
                  f"{sorted(rates)[1]:.1f}")
            print_phases(f"10{leg} {k} shard(s), 3 warm passes", al.timers)
        (one, _), (many, nm) = got[1], got[MESH]
        check(many == one, f"10{leg}: the {MESH}-shard body == one device's")
        # rounds 1 and 3 launch once a shard and end (PE: two ends);
        # round 2 once a wave, and not at all on a shard whose reads
        # give it no candidate (as on one device)
        ends = 2 if leg == "b" else 1
        r1, r2, r3 = nm["k2 rounds"]
        check(r1 == r3 == MESH * ends and r2 >= ends,
              f"10{leg}: K2 rounds 1 and 3 launched on every shard "
              f"({nm['k2 rounds']})")
        check(nm["extend"] > 0 and nm["global_align"] > 0,
              f"10{leg}: K1 and K3 launched on the mesh")
        if leg == "a":
            check(one == se["body"], "10a: the batch-32768 body == phase "
                  "4's (batch 8192)")
            se_body = one
            sa = als[MESH].di.sa
            print(f"[10a] SA copied: one copy of {_nbytes(sa)} B on cuda:0; "
                  f"each of the {MESH} shards reads all of it")
        else:
            check(nm["localsw"] > 0, "10b: K4 launched on the mesh")
            pe_body = one
        print(f"[10{leg}] {MESH}-shard body == one device's "
              f"({len(many)} bytes)")

    # (c) SE with the SA sharded over the mesh
    sh = dataclasses.replace(opt, shard_sa=True)
    al = Aligner(se["idx"], sh, device=mesh)
    body, dt, n = _pass(al, se_run)
    check(body == se_body, "10c: sharded-SA body == one device's")
    rows = se["idx"].sa_ls.shape[0]
    per = [_nbytes(t) for t in al.ssa.shards]
    check(per == [-(-rows // MESH) * 4] * MESH,
          "10c: each shard holds (N+1) padded / 4 rows of int32")
    print(f"[10c] SA sharded: {rows} rows padded to {al.ssa.n_rows}, "
          f"{per} B a shard (the copied SA: {_nbytes(sa)} B); "
          f"body == one device's in {dt:.2f} s; launches {_launch_line(n)}")

    # (d) PE on the forced wide layout with the SA sharded
    al = Aligner(pidx, sh, device=mesh)
    al.di = DeviceIndex.from_host(pidx, al.device, wide=True, sa_stub=True)
    al.ssa = ShardedSA.from_host(pidx, al.mesh.devices, wide=True)
    body, dt, n = _pass(al, pe_run)
    check(body == pe_body, "10d: wide + sharded-SA PE body == one device's")
    check(al.ssa.shards[0].dtype == torch.int64, "10d: the wide layout")
    print(f"[10d] PE wide + SA sharded: body == one device's in {dt:.2f} s; "
          f"{[_nbytes(t) for t in al.ssa.shards]} B a shard; launches "
          f"{_launch_line(n)}")

    # (e) SE with the sampled SA on every shard
    al = Aligner(se["idx"], dataclasses.replace(opt, sa_sample_shift=5),
                 device=mesh)
    body, dt, n = _pass(al, se_run)
    check(body == se_body, "10e: --sa-shift 5 body == one device's")
    check(n["sa_sampled"] >= MESH, "10e: K5 launched on every shard")
    print(f"[10e] --sa-shift 5 on {MESH} shards: body == one device's in "
          f"{dt:.2f} s; launches {_launch_line(n)}")

    # (h) two cards, where there are two
    if n_cards >= 2:
        al = Aligner(se["idx"], dataclasses.replace(opt, mesh_shape=(2,)),
                     device=["cuda:0", "cuda:1"])
        body, dt, n = _pass(al, se_run)
        check(body == se_body, "10h: the body on cuda:0, cuda:1 == one "
              "device's")
        print(f"[10h] cuda:0, cuda:1: body == one device's in {dt:.2f} s")
    else:
        print("[10h] one card: the two-card leg does not run")

    # (f), (g): the CLI
    res = {k: _cli_result(c) for k, c in clis.items()}
    for k in ("f mesh", "f one"):
        check(res[k][2] == 0, f"10{k}: the CLI exits 0: {res[k][1][-2000:]}")
    with open(os.path.join(GOLDEN_DIR, "se.sam")) as f:
        golden = f.read()
    check(_strip_pg(res["f mesh"][0]) == _strip_pg(res["f one"][0])
          == golden, "10f: the mesh CLI's SAM == the one-device CLI's == "
          "tests/golden/se.sam but @PG")
    check(f"mesh of {MESH}: {', '.join(['cuda:0'] * MESH)}" in
          res["f mesh"][1], "10f: the banner names the mesh")
    print(f"[10f] `mem --preset v5e-4 --device {mesh_dev}` == `--batch "
          f"{MESH_BATCH} --device cuda:0` == tests/golden/se.sam (but @PG)")
    out, err, rc = res["g"]
    if n_cards < MESH:
        lines = [ln for ln in err.splitlines()
                 if ln.startswith("tpu-bwa-torch mem:")]
        check(rc == 1 and len(lines) == 1 and "Traceback" not in err,
              f"10g: --device cuda for {MESH} shards on {n_cards} card(s) "
              f"is refused in one line, exit 1 ({rc}: {err[-2000:]})")
        print(f"[10g] {n_cards} card(s): exit 1, {lines[0]!r}")
    else:
        check(rc == 0 and _strip_pg(out) == golden,
              "10g: --device cuda on the cards == 10f")
        print(f"[10g] {n_cards} cards: --device cuda ran, == 10f")
    print(f"[10] the device mesh in {time.monotonic() - t0:.1f} s")


# --------------------------------------------------------------- 11 ----

CHR21_LEN = 46_709_983          # GRCh38 chr21 (N runs included)
CHR21_PAIRS = 10_000
CHR21_WARM = 3
# SHA-256 of the SAM bodies the JAX package writes for phase 11's files
# (tpubwa.align.pipeline.align_fastq, JAX_PLATFORMS=cpu, batch_reads=8192):
# the 20,000 SE reads, and the 10,000 pairs
SE_CHR21_SHA256 = ("704471de08e314533aa05de2d8b4ffd4"
                   "d76ff8a83069d84083c5a96b7264ceb7")
PE_CHR21_SHA256 = ("49eda9223618a629a4a6f5b59df71d99"
                   "c05404106ccd90d801b54c7fdf3c6775")


def chr21_fixture() -> dict:
    """utils.gensim's realistic genome at the length of GRCh38 chr21 (seed
    1234, its N-islands written as N, contig chr21synth), indexed by the
    port (read_fasta + FMIndex.build, timed: 11(a)); 20,000 SE reads of
    150 bp at 1 % error and 10,000 pairs (insert 400 +- 50), seed 7."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import read_fasta
    from tpubwa_torch.utils import gensim, sim

    d = os.path.join(WORK, "chr21")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "chr21synth.fa")
    fx = dict(fa=fa, fq=os.path.join(d, "se.fq"),
              fq1=os.path.join(d, "pe_1.fq"), fq2=os.path.join(d, "pe_2.fq"))
    t = time.monotonic()
    codes, n_mask = gensim.realistic_genome(np.random.default_rng(1234),
                                            CHR21_LEN)
    gensim.write_fasta(fa, codes, n_mask, name="chr21synth")
    n_n = int(n_mask.sum())
    del codes, n_mask
    gen = time.monotonic() - t
    t = time.monotonic()
    contigs, codes, holes = read_fasta(fa)
    idx = FMIndex.build(contigs, codes, holes)
    fx["build_s"] = time.monotonic() - t
    idx.save(fa)
    t = time.monotonic()
    sim.write_fastq(fx["fq"], sim.simulate_reads(codes, contigs, N_READS,
                                                 length=150, err=0.01,
                                                 seed=7))
    r1, r2 = sim.simulate_pairs(codes, contigs, CHR21_PAIRS, length=150,
                                err=0.01, seed=7)
    sim.write_fastq(fx["fq1"], r1)
    sim.write_fastq(fx["fq2"], r2)
    print(f"[11a] chr21-scale realistic genome: {CHR21_LEN} bp ({n_n} N in "
          f"{len(holes)} runs) in {gen:.1f} s; index of {idx.seq_len} "
          f"characters built in {fx['build_s']:.1f} s (read_fasta + "
          f"FMIndex.build); {N_READS} reads and {CHR21_PAIRS} pairs in "
          f"{time.monotonic() - t:.1f} s")
    fx["idx"] = idx
    return fx


def _index_bytes(al) -> str:
    di = al.di
    parts = [f"cp {_nbytes(di.cp)}", f"SA {_nbytes(di.sa)}",
             f"pac {_nbytes(di.pac_words)}"]
    if al.ss is not None:
        parts.append(f"sampled SA {_nbytes(al.ss.vals)} values + "
                     f"{_nbytes(al.ss.blocks)} blocks")
    return f"{str(di.cp.dtype).split('.')[-1]}: " + ", ".join(parts) + " B"


def _warm_passes(tag: str, al, run, body: str, n_reads: int) -> None:
    """CHR21_WARM warm passes, each counted and equal to `body`: reads/s,
    launches, and the phase table of all of them."""
    al.timers = type(al.timers)()
    rates = []
    for i in range(CHR21_WARM):
        text, dt, n = _pass(al, run)
        check(text == body, f"{tag} warm pass {i + 1}: body == the counted "
              "run's")
        rates.append(n_reads / dt)
    print(f"[{tag}] {CHR21_WARM} warm passes (batch {BATCH}): "
          f"{', '.join(f'{r:.1f}' for r in rates)} reads/s; launches a pass "
          f"{_launch_line(n)}")
    print_phases(f"{tag} {CHR21_WARM} warm passes", al.timers)


def _digest(sam: str) -> str:
    return hashlib.sha256(_body(sam).encode()).hexdigest()


def chr21_se(fx: dict, device: str = "cuda") -> dict:
    """11(b): the counted SE run (its K1 waves and _ga_rows calls
    captured), its body against the pinned JAX hash, warm passes, a
    profiled pass."""
    from tpubwa_torch.align import flatsam
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops import global_align_cuda
    from tpubwa_torch.ops.extend_cuda import extend_core

    al = Aligner(fx["idx"], MemOptions(batch_reads=BATCH), device=device)
    print(f"[11b] device index {_index_bytes(al)}")
    waves: dict = {}
    ga: list = []
    al.ext_core = wave_capture(waves)

    def run(a, out):
        run_se_pipeline(a, fx["fq"], out)

    with capture_first(flatsam, "_ga_rows", ga, limit=1024):
        text, cold, n = _pass(al, run)
    al.ext_core = extend_core
    check(n["smem_chain"] > 0 and n["extend"] > 0 and n["global_align"] > 0,
          f"11b: the SE path launched K2, K1 and K3 ({n})")
    check(len(ga) == global_align_cuda.ga_pack.launches,
          "11b: every _ga_rows call of the run captured")
    check(set(waves) == {"left", "left retry", "right", "right retry"},
          "11b: the first left and right waves captured, with retries")
    prim = [ln.split("\t") for ln in text.splitlines()
            if not int(ln.split("\t")[1]) & 0x900]
    mapped = [f for f in prim if not int(f[1]) & 4]
    near = sum(abs(int(f[3]) - 1 - int(f[0].split("_")[3])) <= 50
               for f in mapped)
    digest = _digest(text)
    print(f"[11b] SE counted run: {N_READS} reads in {cold:.2f} s (cold); "
          f"launches {_launch_line(n)}; {len(prim)} primaries, mapped "
          f"{len(mapped)}, within 50 bp {near}; {text.count(chr(10))} "
          f"lines; body sha256 {digest}")
    check(len(prim) == N_READS, "11b: one primary per read")
    check(digest == SE_CHR21_SHA256, "11b: SE SAM body equals the JAX "
          f"package's (sha256 {SE_CHR21_SHA256})")
    _warm_passes("11b", al, run, text, N_READS)
    if device == "cuda":
        profiled_pass("11b", lambda: _timed_se(al, fx["fq"]))
    return dict(aligner=al, body=text, waves=waves, ga=ga)


def chr21_pe(fx: dict, device: str = "cuda") -> dict:
    """11(c): the counted PE run (its first rescue round and _ga_rows
    calls captured), K4 launched, the pinned JAX hash, warm passes."""
    from tpubwa_torch.align import flatsam, pair
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops import global_align_cuda

    al = Aligner(fx["idx"], MemOptions(batch_reads=BATCH), device=device)
    sw: list = []
    ga: list = []

    def run(a, out):
        check(pair.align_pe_fastq(a, fx["fq1"], fx["fq2"], out) == 0,
              "11c: PE exits 0")

    with capture_first(pair, "localsw_core", sw), \
            capture_first(flatsam, "_ga_rows", ga, limit=1024):
        text, cold, n = _pass(al, run)
    check(n["localsw"] > 0, f"11c: the PE path launched K4 ({n})")
    check(n["smem_chain"] > 0 and n["extend"] > 0 and n["global_align"] > 0,
          f"11c: the PE path launched K2, K1 and K3 ({n})")
    check(len(sw) == 1 and len(ga) == global_align_cuda.ga_pack.launches,
          "11c: the first rescue round and every _ga_rows call captured")
    digest = _digest(text)
    flags = [int(ln.split("\t")[1]) for ln in _body(text).splitlines()]
    prim = [f for f in flags if not f & 0x900]
    print(f"[11c] PE counted run: {2 * CHR21_PAIRS} reads in {cold:.2f} s "
          f"(cold); launches {_launch_line(n)}; {len(prim)} primaries, "
          f"mapped {sum(not f & 4 for f in prim)}, proper pair "
          f"{sum(bool(f & 2) for f in prim)}; body sha256 {digest}")
    check(len(prim) == 2 * CHR21_PAIRS, "11c: one primary per end")
    check(digest == PE_CHR21_SHA256, "11c: PE SAM body equals the JAX "
          f"package's (sha256 {PE_CHR21_SHA256})")
    _warm_passes("11c", al, run, text, 2 * CHR21_PAIRS)
    return dict(sw=sw[0][:2], ga=ga)


def chr21_pe250(fx: dict, device: str = "cuda") -> dict:
    """11(h): 2x250 pairs through align_pe_fastq on the chr21-scale index
    (the wide bucket), counted, with its first K1 waves, its first call of
    each K2 round, its first rescue round and its _ga_rows calls
    captured; K2's calls are checked here against the plain chains."""
    from tpubwa_torch.align import flatsam, pair
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import LONG_READ_LEN, WIDE, MemOptions
    from tpubwa_torch.io.fasta import read_fasta
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.extend_cuda import extend_core
    from tpubwa_torch.utils import sim

    d = os.path.dirname(fx["fa"])
    fq1, fq2 = (os.path.join(d, f"pe250_{e}.fq") for e in (1, 2))
    contigs, codes, _ = read_fasta(fx["fa"])
    r1, r2 = sim.simulate_pairs(codes, contigs, CHR21_PAIRS, length=250,
                                isize_mean=550, isize_std=100, err=0.01,
                                seed=8)
    del codes
    sim.write_fastq(fq1, r1)
    sim.write_fastq(fq2, r2)
    al = Aligner(fx["idx"], MemOptions(batch_reads=BATCH), device=device)
    sw: list = []
    ga: list = []
    waves: dict = {}
    rounds = {r: [] for r in ("smem_round1_core", "smem_through_core",
                              "smem_round3_core")}
    al.ext_core = wave_capture(waves)

    def run(a, out):
        check(pair.align_pe_fastq(a, fq1, fq2, out) == 0,
              "11h: 2x250 PE exits 0")

    # K2's rounds are captured where the chains call them (``_cores()``):
    # the names on smem_chain_cuda count the launches and stay as they are
    shim = types.SimpleNamespace(**{r: getattr(k2, r) for r in rounds})
    with contextlib.ExitStack() as stack:
        stack.enter_context(capture_first(pair, "localsw_core", sw))
        stack.enter_context(capture_first(flatsam, "_ga_rows", ga,
                                          limit=1024))
        for name, calls in rounds.items():
            stack.enter_context(capture_first(shim, name, calls))
        stack.callback(setattr, plain, "_cores", plain._cores)
        plain._cores = lambda: shim
        text, cold, n = _pass(al, run)
    al.ext_core = extend_core
    c = al.timers.counters
    flags = [int(ln.split("\t")[1]) for ln in _body(text).splitlines()]
    prim = [f for f in flags if not f & 0x900]
    batches = -(-CHR21_PAIRS // BATCH)
    print(f"[11h] 2x250 PE counted run: {2 * CHR21_PAIRS} reads in "
          f"{cold:.2f} s (cold); launches {_launch_line(n)}; {len(prim)} "
          f"primaries, mapped {sum(not f & 4 for f in prim)}, proper pair "
          f"{sum(bool(f & 2) for f in prim)}; counters "
          f"{json.dumps(dict(sorted(c.items())))}")
    print_phases("11h", al.timers)
    check(len(prim) == 2 * CHR21_PAIRS, "11h: one primary per end")
    check(c["fastq.wide_batches"] == batches,
          f"11h: every batch in the wide bucket ({batches})")
    check(c["pair.rescue_truncated"] == 0, "11h: no rescue job cut")
    check(c["sam.generator_reads"] <= 0.01 * 2 * CHR21_PAIRS,
          "11h: the generator tier took at most 1 % of the reads")
    check(sum(bool(f & 2) for f in prim) >= 0.95 * len(prim),
          "11h: at least 95 % of the ends in proper pairs")
    check(n["localsw"] > 0 and n["extend"] > 0 and n["global_align"] > 0,
          f"11h: the 2x250 path launched K1, K3 and K4 ({n})")
    q, t = sw[0][0][0], sw[0][0][2]
    check(q.shape[1] == WIDE.rescue_q and t.shape[1] in (256, WIDE.rescue_t),
          f"11h: the rescue round ran at the wide pads ({q.shape[1]} x "
          f"{t.shape[1]})")
    check(all(a[0].shape[1] == WIDE.sam_q and a[1].shape[1] == WIDE.sam_t
              for a, _, _ in ga),
          "11h: every _ga_rows call on the wide windows")
    check({"left", "right"} <= set(waves)
          and all(a[0].shape[1] == WIDE.ext_q for a, _ in waves.values()),
          f"11h: the first left and right K1 waves captured at Q "
          f"{WIDE.ext_q} ({sorted(waves)})")
    # K2's first call of each round on the run's 256-wide codes
    err = 0
    plains = {"smem_round1_core": plain.smem_round1_chain,
              "smem_through_core": plain.smem_through_chain,
              "smem_round3_core": plain.smem_round3_chain}
    with keep_launches():
        for name, calls in rounds.items():
            check(len(calls) == 1, f"11h: K2 {name} captured")
            args, kw, _ = calls[0]
            check(args[1].shape[1] == LONG_READ_LEN,
                  f"11h: K2 {name} ran on codes {LONG_READ_LEN} wide")
            got = getattr(k2, name)(*args, **kw)
            err = max(err, _same_smems(f"11h 2x250 {name}", got,
                                       plains[name](*args, **kw)))
            print(f"[11h] K2 {name}: B={args[1].shape[0]} "
                  f"L={args[1].shape[1]} cap {kw['cap']}: kernel == plain on "
                  f"whole buffers, {int(got.n.sum())} SMEMs")
    return dict(sw=sw[0][:2], ga=ga, waves=waves, smem=dict(max_abs_err=err))


def chr21_modes(fx: dict, se_body: str, device: str = "cuda") -> list:
    """11(d): --sa-shift 5 (K5 counted, its calls captured) and the forced
    wide layout; each SE body == 11(b)'s.  Returns the K5 calls."""
    import torch

    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops import seeds
    from tpubwa_torch.ops.fm import DeviceIndex

    def run(a, out):
        run_se_pipeline(a, fx["fq"], out)

    idx = fx["idx"]
    k5_calls_seen: list = []
    als = {"--sa-shift 5": Aligner(idx, MemOptions(batch_reads=BATCH,
                                                   sa_sample_shift=5),
                                   device=device),
           "wide": Aligner(idx, MemOptions(batch_reads=BATCH),
                           device=device)}
    als["wide"].di = DeviceIndex.from_host(idx, torch.device(device),
                                           wide=True)
    for mode, al in als.items():
        with capture_first(seeds, "sa_lookup_sampled_core", k5_calls_seen,
                           limit=64):
            text, cold, n = _pass(al, run)
        check(text == se_body, f"11d: {mode} SE body == 11b's")
        if mode == "--sa-shift 5":
            check(n["sa_sampled"] > 0 and len(k5_calls_seen)
                  == n["sa_sampled"], "11d: --sa-shift 5 launched K5, "
                  "every call captured")
        text, warm, _ = _pass(al, run)
        check(text == se_body, f"11d: {mode} warm SE body == 11b's")
        print(f"[11d] {mode}: body == 11b's ({cold:.2f} s cold); warm "
              f"{N_READS / warm:.1f} reads/s; launches {_launch_line(n)}; "
              f"device index {_index_bytes(al)}")
    return k5_calls_seen


def phase_high_words(idx, fq: str, device: str = "cuda") -> dict:
    """11(g): K2 and K5 against their plain versions where the wide
    layout's values lie at or above 2^31.  (1) utils.sim.high_word_index
    (occ counts and SA values + 2^31 + 12,345, L2 minus that): K5 ==
    plain == the SA + the offset.  (2) The same index with every row
    moved up by delta >= 2^31 (a multiple of 64: delta / 64 empty
    checkpoint and directory rows in front, L2 and primary + delta):
    K2's three rounds == plain, and their intervals == those on the
    unmoved index + delta; K5 on the moved rows == plain == the SA + the
    offset.  K2 does not run on (1): it starts an interval at L2[c],
    which (1) lowers by the offset, so the rows would be negative."""
    import torch

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops import smem_chain as plain
    from tpubwa_torch.ops import smem_chain_cuda as k2
    from tpubwa_torch.ops.fm import (DeviceIndex, SampledSA,
                                     build_sampled_sa, sa_lookup_sampled)
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core
    from tpubwa_torch.utils.sim import (HIGH_WORD, high_word_index,
                                        sa_edge_rows)

    dev = torch.device(device)
    shift = 5
    err = 0
    rng = np.random.default_rng(11)
    rows_h = np.concatenate([sa_edge_rows(idx, shift), rng.integers(
        0, idx.sa_ls.shape[0], 1 << 20)])
    want_sa = torch.as_tensor(idx.sa[rows_h] + HIGH_WORD, device=dev)
    rows = torch.as_tensor(rows_h, device=dev)
    with keep_launches():
        arr = high_word_index(idx, shift)
        di = DeviceIndex.from_numpy(arr, dev)
        ss = SampledSA.from_numpy(arr, dev)
        check(int(di.cp[:, 0:4].min()) >= 1 << 31 and int(ss.vals.min())
              >= 1 << 31, "11g: counts and samples at or above 2^31")
        got = sa_lookup_sampled_core(di, ss, rows, shift)
        check(torch.equal(got, sa_lookup_sampled(di, ss, rows, shift))
              and torch.equal(got, want_sa), "11g: K5 == plain == SA + "
              "offset on the index of high counts")
        print(f"[11g] counts + {HIGH_WORD} (L2 - {HIGH_WORD}): K5 == plain "
              f"== SA + {HIGH_WORD} on {rows.numel()} rows")
        del di, ss, arr

        base = DeviceIndex.from_host(idx, dev, wide=True, sa_stub=True)
        delta = -(-HIGH_WORD // 64) * 64
        pad = delta // 64
        cp = torch.zeros((pad + base.cp.shape[0], 8), dtype=torch.int64,
                         device=dev)
        cp[pad:] = base.cp
        moved = base._replace(cp=cp, L2=base.L2 + delta,
                              primary=base.primary + delta)
        sb = build_sampled_sa(None, shift, True, idx=idx, device=dev)
        blocks = torch.zeros((pad + sb.blocks.shape[0], 4),
                             dtype=torch.int64, device=dev)
        blocks[pad:] = sb.blocks
        ss = SampledSA(blocks=blocks, vals=sb.vals + HIGH_WORD)
        got = sa_lookup_sampled_core(moved, ss, rows + delta, shift)
        check(torch.equal(got, sa_lookup_sampled(moved, ss, rows + delta,
                                                 shift))
              and torch.equal(got, want_sa), "11g: K5 == plain == SA + "
              "offset on rows + delta")
        print(f"[11g] rows + {delta} (tables of {_nbytes(cp)} and "
              f"{_nbytes(blocks)} B): K5 == plain == SA + {HIGH_WORD} on "
              f"{rows.numel()} rows")

        opt = MemOptions()
        msl, cap = opt.min_seed_len, opt.max_smems_per_read
        codes, lens_h = first_batch(fq)
        q = torch.as_tensor(codes, device=dev)
        lens = torch.as_tensor(lens_h, device=dev)
        G = 2 * q.shape[0]
        out = {}
        for name, d in (("base", base), ("moved", moved)):
            _, src_tab, r1s, r1e, r1n, total = plain._smem_r1_prep(
                d, q, lens, min_seed_len=msl, split_len=opt.split_len,
                split_width=opt.split_width, out_cap=cap)
            lanes = plain._r2_lanes(src_tab, r1s, r1e, r1n, total, 0,
                                    out_cap=cap, G=G)
            out[name] = {
                "r1": (k2.smem_round1_core, plain.smem_round1_chain,
                       (d, q, lens), dict(min_seed_len=msl, cap=cap)),
                "r2": (k2.smem_through_core, plain.smem_through_chain,
                       (d, q, lens, *lanes), dict(min_seed_len=msl, cap=32)),
                "r3": (k2.smem_round3_core, plain.smem_round3_chain,
                       (d, q, lens), dict(min_seed_len=msl, cap=cap,
                                          max_mem_intv=opt.max_mem_intv))}
        for r in ("r1", "r2", "r3"):
            core, ref, args, kw = out["moved"][r]
            got = core(*args, **kw)
            err = max(err, _same_smems(f"11g moved {r}", got, ref(*args,
                                                                  **kw)))
            core, _, args, kw = out["base"][r]
            low = core(*args, **kw)
            M = low.k.shape[1]
            live = torch.arange(M, device=dev)[None] < low.n.clamp(
                max=M)[:, None]
            check(torch.equal(got.k[live], low.k[live] + delta)
                  and torch.equal(got.l[live], low.l[live] + delta)
                  and all(torch.equal(getattr(got, f), getattr(low, f))
                          for f in ("s", "start", "end", "n", "overflow")),
                  f"11g: K2 {r} on rows + delta == the unmoved index's + "
                  "delta")
            print(f"[11g] K2 {r}: rows + {delta}: kernel == plain on whole "
                  f"buffers, == the unmoved index's + delta on "
                  f"{int(live.sum())} SMEMs (k from "
                  f"{int(got.k[live].min()) if live.any() else 0})")
    return dict(max_abs_err=err)


def phase_chr21(res: dict) -> None:
    """Phase 11: the main path at chr21 scale (a)-(g); each comparison's
    result joins `res`."""
    t0 = time.monotonic()
    fx = chr21_fixture()
    se = chr21_se(fx)
    pe = chr21_pe(fx)
    pe250 = chr21_pe250(fx)
    k5_seen = chr21_modes(fx, se["body"])
    # (e) every kernel of the path against its plain version on this index
    res["smem_chain"].append(
        phase_k2({"chr21": (fx["fa"], fx["fq"])}, prefix="11e")["chr21"])
    for side, (a, k) in sorted(se["waves"].items()):
        res["extend"].append(compare("extend", f"chr21 SE batch 1 {side} "
                                     "core", a, k))
    res["global_align"].append(ga_calls("chr21 SE", se["ga"]))
    res["global_align"].append(ga_calls("chr21 PE", pe["ga"]))
    res["localsw"].append(compare("localsw", "chr21 PE batch 1 first rescue "
                                  "round", *pe["sw"]))
    res["global_align"].append(ga_calls("chr21 2x250", pe250["ga"]))
    res["localsw"].append(compare("localsw", "chr21 2x250 batch 1 first "
                                  "rescue round", *pe250["sw"]))
    for side, (a, k) in sorted(pe250["waves"].items()):
        for kern in ("extend", "extend_b"):
            res[kern].append(compare(kern, f"chr21 2x250 batch 1 {side} "
                                     "core", a, k))
    res["smem_chain"].append(pe250["smem"])
    k5_calls(k5_seen, 5, tag="11e")
    # (f) the card's dependent gathers on this index's tables
    gather_rate(fx["idx"], tag="11f", beyond_l2=True)
    # (g) values at and above 2^31
    hw = phase_high_words(fx["idx"], fx["fq"])
    res["smem_chain"].append(hw)
    res["sa_sampled"].append(hw)
    print(f"[11] chr21 scale in {time.monotonic() - t0:.1f} s (index build "
          f"{fx['build_s']:.1f} s)")


# --------------------------------------------------------------- 12 ----

# reads of each first batch that the per-read path runs (phase 12(a))
PER_READ_READS = {"SE": BATCH, "PE read 1": BATCH}


def _reg_rows(regs) -> list:
    import dataclasses

    return [[dataclasses.astuple(r) for r in rl] for rl in regs]


def _chain_rows(chains_per_read) -> list:
    return [[(c.pos, c.rid, c.w, c.frac_rep,
              [(s.rbeg, s.qbeg, s.len) for s in c.seeds]) for c in chains]
            for chains in chains_per_read]


def _counted_rounds(lanes: list):
    """Context manager: the Aligner's round loop runs as it is, and the
    lanes of each of its rounds are kept in `lanes`."""
    import contextlib

    from tpubwa_torch.align import pipeline

    real = pipeline.run_extension_rounds

    def counting(gens, opt, extend_round, *a, **kw):
        def counted(round_lanes):
            lanes.append(len(round_lanes["h0"]))
            return extend_round(round_lanes)
        return real(gens, opt, counted, *a, **kw)

    @contextlib.contextmanager
    def cm():
        pipeline.run_extension_rounds = counting
        try:
            yield
        finally:
            pipeline.run_extension_rounds = real

    return cm()


def python_chains(al, rows: np.ndarray, l_rep: np.ndarray, lens) -> list:
    """chain_read + filter_chains (the Python reference) of each read."""
    from tpubwa_torch.align import chain

    opt = al.opt
    bounds = np.searchsorted(rows[:, 0], np.arange(len(lens) + 1))
    out = []
    for b in range(len(lens)):
        if lens[b] < opt.min_seed_len:
            out.append([])
            continue
        seeds = [chain.Seed(int(r[1]), int(r[2]), int(r[3]), int(r[3]))
                 for r in rows[bounds[b]:bounds[b + 1]]]
        out.append(chain.filter_chains(opt, chain.chain_read(
            opt, al.idx.l_pac, al.contig_offsets, seeds, int(lens[b]),
            int(l_rep[b]))))
    return out


def per_read_batch(tag: str, fa: str, fq: str,
                   device: str = "cuda") -> dict:
    """12(a): the first batch of `fq` through seed_batch -> chain_batch ->
    extend_batch_rounds under layouts t and b, each run counted; the
    regions equal the flat engine's (regions_batch) field for field, and
    the native chains equal chain_read + filter_chains.  Returns the
    launches of each layout's run."""
    import dataclasses

    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fastq import stream_batches

    idx = FMIndex.load(fa)
    opt = MemOptions(batch_reads=BATCH)
    batch = next(iter(stream_batches(fq, BATCH, opt.max_read_len)))
    n = PER_READ_READS[tag]
    if n < batch.n:
        print(f"[12a] {tag}: cut to the batch's first {n} of {batch.n} "
              "reads (the per-read path is host Python)")
        batch = dataclasses.replace(
            batch, codes=batch.codes[:n], lens=batch.lens[:n],
            names=batch.names[:n], seqs=batch.seqs[:n],
            quals=batch.quals[:n])
    flat = None
    out = {}
    for layout, kern, other in (("t", "extend", "extend_b"),
                                ("b", "extend_b", "extend")):
        al = Aligner(idx, opt, device=device, ext_layout=layout)
        if flat is None:
            t = time.monotonic()
            flat = _reg_rows(al.regions_batch(batch))
            flat_s = time.monotonic() - t
        al.timers = type(al.timers)()
        lanes: list = []
        with _counted_rounds(lanes):
            _sync(device)
            reset_launches()
            t = time.monotonic()
            rows, l_rep = al.seed_batch(batch.codes, batch.lens)
            chains = al.chain_batch(rows, l_rep, batch.lens)
            regs = al.extend_batch_rounds(batch.codes, batch.lens, chains)
            _sync(device)
            secs = time.monotonic() - t
            launches = read_launches()
        got = _reg_rows(regs[:batch.n])
        check(got == flat, f"12a {tag}, layout {layout}: per-read regions "
              "== the flat engine's, field for field")
        check(launches[kern] > 0 and launches[other] == 0,
              f"12a {tag}, layout {layout}: the rounds launched {kern}")
        check(launches["smem_chain"] > 0, f"12a {tag}: K2 launched")
        print(f"[12a] {tag}, layout {layout}: {batch.n} reads, "
              f"{sum(map(len, got))} regions == the flat engine's field "
              f"for field ({flat_s:.2f} s there); {len(lanes)} rounds, "
              f"{lanes[0]} lanes in the first, {lanes[-1]} in the last, "
              f"{sum(lanes)} in all; launches K1 {launches['extend']}, K1b "
              f"{launches['extend_b']}, K2 {launches['smem_chain']}; "
              f"{secs:.2f} s")
        print_phases("12a", al.timers)
        out[layout] = launches
        if layout == "t":
            t = time.monotonic()
            py = python_chains(al, rows, l_rep, batch.lens)
            check(_chain_rows(chains) == _chain_rows(py),
                  f"12a {tag}: native chains == chain_read + filter_chains")
            print(f"[12a] {tag}: native chains == chain_read + "
                  f"filter_chains on all {batch.n} reads "
                  f"({sum(map(len, py))} chains; Python "
                  f"{time.monotonic() - t:.2f} s)")
    return out


def phase_step(fa: str, fq: str, device: str = "cuda") -> dict:
    """12(b): device_align_step on SE batch 1 at full width; returns K1's
    comparison on its windows and the step's launches."""
    import torch

    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops.extend import _extend_core
    from tpubwa_torch.ops.seeds import (compact_seeds, seed_rows,
                                        smems_to_seeds)
    from tpubwa_torch.ops.smem_chain import collect_smems_chain
    from tpubwa_torch.parallel.mesh import (STEP_EXT, device_align_step,
                                            make_mesh, sharded_align_step,
                                            step_windows)

    opt = MemOptions(batch_reads=BATCH)
    al = Aligner(FMIndex.load(fa), opt, device=device)
    codes, lens = first_batch(fq)
    c = torch.as_tensor(codes, device=device)
    n = torch.as_tensor(lens, device=device)
    B, L = codes.shape

    def step():
        return device_align_step(al.di, c, n, al.mat_dev)

    _sync(device)
    reset_launches()
    out, cold_ms = _timed(step)
    launches = read_launches()
    check(launches["smem_chain"] > 0 and launches["extend"] > 0,
          "12b: device_align_step launched K2 and K1")
    with keep_launches():
        ms = _cuda_ms(step, reps=3)
        # its pieces on the same batch
        sm = collect_smems_chain(al.di, c, n, min_seed_len=opt.min_seed_len)
        sb = smems_to_seeds(al.di, sm, max_occ=opt.max_occ, out_seeds=64)
        for f, g, w in zip(("rbeg", "qbeg", "len", "valid"), out, sb):
            check(torch.equal(g, w), f"12b: the step's {f} == "
                  "smems_to_seeds'")
        cs = compact_seeds(sb)
        sr = seed_rows(al.di, sm, max_occ=opt.max_occ,
                       per_read_cap=opt.max_seeds_per_read)
        ok = ~(sb.overflow | sm.overflow | sr.overflow).cpu().numpy()
        a = cs.packed[:int(cs.n)].cpu().numpy()
        b = sr.packed[:int(sr.n)].cpu().numpy()
        check(np.array_equal(a[ok[a[:, 0]]], b[ok[b[:, 0]]]),
              "12b: compact_seeds rows == seed_rows on reads with no cap")
        check(torch.equal(cs.l_rep, sr.l_rep), "12b: l_rep == seed_rows'")
        args = step_windows(al.di, c, n, sb, al.mat_dev)
        plain = _extend_core(*args, **STEP_EXT)
        check(torch.equal(out[4], plain.score),
              "12b: the step's scores == the plain _extend_core's")
        k1 = compare("extend", "device_align_step's windows", args,
                     STEP_EXT)
        mesh = make_mesh(None, [device + ":0" if device == "cuda"
                                else device] * 4)
        sh, sh_ms = _timed(lambda: sharded_align_step(mesh, al.di, codes,
                                                      lens, al.mat))
        for f, g, w in zip(("rbeg", "qbeg", "len", "valid", "score"), sh,
                           out):
            check(torch.equal(g, w), f"12b: four shards' {f} == one "
                  "device's")
    print(f"[12b] device_align_step, B={B} L={L}: {int(cs.n)} seed rows, "
          f"{int(ok.sum())} reads without a cap, rows == seed_rows' there; "
          f"scores == plain on {int((out[4] > 0).sum())} reads with a "
          f"seed; launches K2 {launches['smem_chain']}, K1 "
          f"{launches['extend']}; {cold_ms:.3f} ms cold, {ms:.3f} ms warm "
          f"(CUDA events); 4 shards on cuda:0 == one device "
          f"({sh_ms:.3f} ms)")
    return dict(k1=k1, launches=launches, ms=ms)


def phase_oracles(fa: str, fq: str, device: str = "cuda") -> dict:
    """12(c): K1 and K1b against extend_ref on 512 random jobs; K2 against
    fm_ref.collect_smems on 64 reads of SE batch 1.  Returns each
    kernel's max |err|."""
    import torch

    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops import fm_ref
    from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
    from tpubwa_torch.ops.extend_ref import extend_ref
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.ops.smem_chain import collect_smems_chain

    errs = {}
    args, kw = random_jobs(0, J_RAND, Q_RAND, T_RAND)
    J = 512
    query, qlen, target, tlen, mat, w, h0, bonus = (
        a[:J] if a.ndim and a.shape[0] == J_RAND else a for a in args)
    t = time.monotonic()
    want = np.array([list(vars(extend_ref(
        query[j, :qlen[j]].astype(np.uint8),
        target[j, :tlen[j]].astype(np.uint8), mat, kw["o_del"],
        kw["e_del"], kw["o_ins"], kw["e_ins"], int(w[j]), int(bonus[j]),
        kw["zdrop"], int(h0[j]))).values()) for j in range(J)])
    ref_s = time.monotonic() - t
    dev_args = tuple(torch.as_tensor(a, device=device) for a in
                     (query, qlen, target, tlen, mat, w, h0, bonus))
    with keep_launches():
        for name, fn in (("extend", extend_core), ("extend_b",
                                                   extend_core_b)):
            got = torch.stack(list(fn(*dev_args, **kw))).T.cpu().numpy()
            errs[name] = int(np.abs(got.astype(np.int64) - want).max())
            check(errs[name] == 0, f"12c: {name} == extend_ref on {J} jobs")
    print(f"[12c] K1 and K1b == extend_ref on {J} random jobs (Q={Q_RAND} "
          f"T={T_RAND}), all six fields; the oracle {ref_s:.1f} s on the "
          "host")

    idx = FMIndex.load(fa)
    codes, lens = first_batch(fq)
    di = DeviceIndex.from_host(idx, device)
    with keep_launches():
        sm = collect_smems_chain(di, torch.as_tensor(codes, device=device),
                                 torch.as_tensor(lens, device=device))
        fields = [f.cpu().numpy() for f in sm[:5]]
        nm = sm.n.cpu().numpy()
        ovf = sm.overflow.cpu().numpy()
    t = time.monotonic()
    n_mems = 0
    for b in range(64):
        check(not ovf[b], f"12c: read {b} within the SMEM cap")
        want_b = [(m.k, m.l, m.s, m.start, m.end)
                  for m in fm_ref.collect_smems(idx, codes[b],
                                                int(lens[b]))]
        got_b = list(zip(*(f[b, :nm[b]].tolist() for f in fields)))
        check(got_b == want_b, f"12c: K2 == fm_ref.collect_smems, read {b}")
        n_mems += len(want_b)
    errs["smem_chain"] = 0
    print(f"[12c] K2 (collect_smems_chain on the whole batch) == "
          f"fm_ref.collect_smems on its first 64 reads: {n_mems} SMEMs "
          f"(k, l, s, start, end); the oracle {time.monotonic() - t:.1f} s "
          "on the host")
    return errs


def phase_suffix_array() -> None:
    """12(d): an index built by NumPy prefix doubling == the native
    SA-IS build, 200 kb genome (host only)."""
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.io.fasta import Contig

    codes = np.random.default_rng(12).integers(0, 4, 200_000).astype(
        np.uint8)
    contigs = [Contig("c1", codes.size, 0)]
    t = time.monotonic()
    a = FMIndex.build(contigs, codes, use_native=False)
    t_np = time.monotonic() - t
    t = time.monotonic()
    b = FMIndex.build(contigs, codes, use_native=True)
    t_nat = time.monotonic() - t
    for f in ("sa_ls", "sa_ms", "cp", "L2"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"12d: {f} by doubling == native")
    check(a.primary == b.primary, "12d: primary by doubling == native")
    print(f"[12d] 200 kb genome: the index by NumPy prefix doubling == "
          f"native SA-IS (SA, checkpoints, L2, primary); {t_np:.2f} s vs "
          f"{t_nat:.2f} s")


def phase_per_read_fused(fa: str, fq: str, pe_files: tuple, res: dict,
                         card: str) -> dict:
    """Phase 12 (a)-(d); the oracles' errors join `res`.  Returns the
    launches of the per-read runs and of the device step."""
    t0 = time.monotonic()
    per_read = {"SE": per_read_batch("SE", fa, fq),
                "PE read 1": per_read_batch("PE read 1", pe_files[0],
                                            pe_files[1])}
    step = phase_step(fa, fq)
    res["extend"].append(step["k1"])
    errs = phase_oracles(fa, fq)
    for k, e in errs.items():
        res[k].append(dict(max_abs_err=e))
    phase_suffix_array()
    print(f"[12] per-read and fused paths in {time.monotonic() - t0:.1f} s "
          f"on {card}")
    return dict(per_read=per_read, step=step["launches"])


# --------------------------------------------------------------- 13 ----

BENCH_MB = 46           # bench.py's chr21-style configurations
# SHA-256 of the SAM bodies the JAX package writes for bench.py's 46 Mb
# chr21-style files (bench._ensure_fixture(46, 20000, pe, "chr21");
# tpubwa.align.pipeline.run_se_pipeline / tpubwa.align.pair.align_pe_fastq,
# JAX_PLATFORMS=cpu, batch_reads=8192, workers 1): the 20,000 SE reads,
# and the 10,000 pairs
SE46_SHA256 = ("e5aa6f9581aca71d33c6c57e6dbc5fef"
               "37520eb0728b08db1b6238fe92dff77b")
PE46_SHA256 = ("1328cd986f0837305d222a6babf29d52"
               "c5b51a835c6beba2cd36e4c5c82ec0a3")


def phase_bench(se_body: str, card: str, device: str = "cuda") -> None:
    """13(a): tools.bench at bench.py's four configurations."""
    from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
    from tpubwa_torch.tools import bench

    t0 = time.monotonic()
    base = ["--device", device, "--work", WORK, "--reads", str(N_READS),
            "--batch", str(BATCH), "--passes", "3"]
    chr21 = ["--ref-mb", str(BENCH_MB), "--style", "chr21"]
    runs = ((f"SE {REF_MB} Mb random", ["--ref-mb", str(REF_MB)],
             hashlib.sha256(se_body.encode()).hexdigest(), "phase 4's body"),
            (f"SE {BENCH_MB} Mb chr21-style", chr21, SE46_SHA256,
             "the JAX package's"),
            (f"PE {BENCH_MB} Mb chr21-style", chr21 + ["--pe"], PE46_SHA256,
             "the JAX package's"))
    t = time.monotonic()
    bench.ensure_fixture(BENCH_MB, N_READS, False, "chr21", WORK)
    print(f"[13a] bench.py's {BENCH_MB} Mb chr21-style genome, its index "
          f"and {N_READS} SE reads built in {time.monotonic() - t:.1f} s")
    for tag, extra, want, whose in runs:
        t = time.monotonic()
        rec = bench.run(base + extra)
        print(f"[13a] {tag} ({time.monotonic() - t:.1f} s with the "
              f"fixture and warm-up): {json.dumps(rec)}")
        check(rec["card"] == card, f"13a: {tag} record names the card")
        check(rec["sam_body_sha256"] == want,
              f"13a: {tag} SAM body equals {whose} (sha256 {want})")
    for layout, counter in (("t", extend_core), ("b", extend_core_b)):
        n0 = counter.launches
        rec = bench.run(["--kernel", "--device", device, "--ext-layout",
                         layout])
        print(f"[13a] --kernel layout {layout}: {json.dumps(rec)}")
        check(rec["card"] == card, f"13a: --kernel {layout} names the card")
        check(rec["max_abs_err"] == 0, f"13a: --kernel {layout}: the last "
              "call's results == the plain version's")
        calls = 4 * bench.REP if device == "cuda" else 0   # warm + 3 runs
        check(counter.launches - n0 == rec["launches"] == calls,
              f"13a: --kernel {layout}: {counter.__name__}.launches grew "
              "by the calls made")
    print(f"[13a] bench.py's configurations in "
          f"{time.monotonic() - t0:.1f} s")


def phase_profilers(card: str, device: str = "cuda") -> None:
    """13(b), (c): tools.profile_se and tools.profile_pe (each raises when
    its replayed text differs from the production path's)."""
    from tpubwa_torch.tools import profile_pe, profile_se

    t0 = time.monotonic()
    for mb, style in ((REF_MB, "random"), (BENCH_MB, "chr21")):
        rec, _ = profile_se.profile(mb, style, device, WORK)
        print(f"[13b] profile_se {mb} Mb {style}: replay == "
              f"align_se_text; {json.dumps(rec)}")
        check(rec["card"] == card, "13b: profile_se record names the card")
    rec, _ = profile_pe.profile(BENCH_MB, device, 35, WORK)
    print(f"[13c] profile_pe {BENCH_MB} Mb chr21: profiled batch == the "
          f"driver's call; {json.dumps(rec)}")
    check(rec["card"] == card, "13c: profile_pe record names the card")
    print(f"[13] profilers in {time.monotonic() - t0:.1f} s")


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

    from tpubwa_torch.tools.big import card_line

    t_start = time.monotonic()
    card = card_line()
    check(card is not None, "nvidia-smi reads the card's name and limit")
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
    for kern, name, a, k in edge_sets():
        res[kern].append(compare(kern, name, a, k))
    fa, fq = se_fixture()
    pe_files = pe_fixture()
    res["smem_chain"] = [phase_k2({"se": (fa, fq),
                                   "pe": (pe_files[0], pe_files[1])})["se"]]
    res["smem_chain"].append(phase_k2_edge())
    res["global_align"] = [phase_k3(), phase_k3_edge()]
    phase_golden()
    se = phase_se(fa, fq)
    gather_rate(se["idx"])
    for side, (a, k) in sorted(se["captured"].items()):
        ms = {}
        for kern in ("extend", "extend_b"):
            res[kern].append(compare(kern, f"SE batch 1 {side} core", a, k))
            ms[kern] = res[kern][-1]["ms"]
        print(f"[k1b] SE batch 1 {side} core: K1b {ms['extend_b']:.3f} ms "
              f"beside K1 {ms['extend']:.3f} ms; {band_share(a, k)}")
    ga_real = ga_calls("SE", se["ga"])
    res["global_align"].append(ga_real)
    pe_launches, b_launches, (sw_args, sw_kw), pe_ga = phase_pe(pe_files)
    sw_real = compare("localsw", "PE batch 1 first rescue round", sw_args,
                      sw_kw)
    res["localsw"].append(sw_real)
    res["global_align"].append(ga_calls("PE", pe_ga))
    res["extend_b_variant"] = [phase_ablation()]
    k5 = phase_k5(se["idx"])
    res["sa_sampled"] = [k5]
    k5_launches = phase_index_modes(se, pe_files)
    phase_serving(se)
    phase_mesh(se, pe_files)
    phase_chr21(res)
    new_paths = phase_per_read_fused(fa, fq, pe_files, res, card)
    phase_bench(se["body"], card)
    phase_profilers(card)

    check("jax" not in sys.modules, "the port ran without importing jax")
    check(not [m for m in sys.modules
               if m == "tpubwa" or m.startswith("tpubwa.")],
          "the port ran without importing the JAX package")
    print(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")

    # launches: each kernel's count in the run that drives it (K2, K1, K4
    # and K3 in phase 5's counted layout-t run, K1b in its layout-b pass,
    # K5 in phase 8(a)'s --sa-shift 5 run, K1c in phase 6, the only path
    # that runs it); error over every comparison; times and bounds at the
    # path's shapes (K1/K1b: the full wave J=8192 Q=192 T=768; K2: the
    # three rounds on the SE run's first batch; K3: the SE run's first
    # _ga_rows call; K4: the PE run's first rescue round; K5: every row of
    # the SE index at shift 5, narrow)
    launches = dict(extend=pe_launches["extend"],
                    extend_b=b_launches["extend_b"],
                    extend_b_variant=res["extend_b_variant"][0]["launches"],
                    smem_chain=pe_launches["smem_chain"],
                    global_align=pe_launches["global_align"],
                    localsw=pe_launches["localsw"],
                    sa_sampled=k5_launches["sa_sampled"])
    print(f"[launches] SE counted run: {se['launches']}")
    print(f"[launches] phase 12: per-read path "
          f"{json.dumps(new_paths['per_read'])}; device_align_step "
          f"{new_paths['step']}")
    timing = dict(extend=res["extend"][0], extend_b=res["extend_b"][0],
                  extend_b_variant=res["extend_b_variant"][0],
                  smem_chain=res["smem_chain"][0], global_align=ga_real,
                  localsw=sw_real, sa_sampled=k5)
    for k, n in launches.items():
        check(n > 0, f"{k} was launched on the path that runs it")
    print(json.dumps({"kernels": [dict(
        name=k, route="cuda", source=KERNELS[k][0], replaces=KERNELS[k][1],
        launches=launches[k],
        max_abs_err=max(r["max_abs_err"] for r in res[k]),
        **{f: timing[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")})
        for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
