#!/usr/bin/env python3
"""The seeding kernels of the PyTorch port against their plain versions on
a genome of real size, on one NVIDIA GPU.  Run from the repository root
after ``tools.big`` has built and served the genome in DIR:

    python -m tpubwa_torch.tools.big --work DIR                # shift 5
    python -m tpubwa_torch.tools.big --work DIR --sa-shift 0   # full SA
    python3 chip_big.py DIR

The genome is ``tools.big``'s default (1.2 Gbp, 20,000 reads): an index
text of 2.4 x 10^9 characters, so the wide layout, whose rows, ``L2[4]``,
primary row and SA values reach past 2^31.  On the card:

1. The serve records of ``--sa-shift 5`` and ``--sa-shift 0`` name the
   same SAM body (SHA-256) and record count.
2. K2's three rounds on the first 8192 reads equal the plain chains on
   whole buffers, also at caps small enough to overflow
   (``chip_smoke.phase_k2``, wide layout), with times, steps a lane and
   the time of a step on the longest chain; and how many of round 1's
   SMEMs have an interval reaching 2^31.
3. K5 at shift 5 on the rows whose walk is longest, the primary row and
   its neighbours, rows 0 and N and 2^20 random rows equals its plain
   version and the full SA, with times.
4. The time of one dependent gather over the wide checkpoint table and
   over the SA (``utils.gather_latency``): tables far beyond the L2.

Any disagreement exits non-zero.  The card line comes first, a JSON
summary last.
"""
from __future__ import annotations

import json
import os
import sys
import time

import chip_smoke
from chip_smoke import _cuda_ms, _timed, check, keep_launches

SHIFT = 5


def serve_records(work: str, ref_len: int) -> dict:
    """1: the two serve records wrote one SAM body."""
    recs = {}
    for shift in (SHIFT, 0):
        with open(os.path.join(work, f"serve_{ref_len}_s{shift}.json")) as f:
            recs[shift] = json.load(f)
    a, b = recs[SHIFT], recs[0]
    for key in ("sam_body_sha256", "sam_records", "mapped_near_truth_frac"):
        check(a[key] == b[key], f"shift {SHIFT} and shift 0 agree on {key}")
    print(f"[big] shift {SHIFT} and 0: one SAM body ({a['sam_records']} "
          f"records, {a['mapped_near_truth_frac']} within 50 bp, SHA-256 "
          f"{a['sam_body_sha256']})")
    return {k: a[k] for k in ("sam_records", "mapped_near_truth_frac",
                              "sam_body_sha256")}


def high_intervals(di, fq: str) -> dict:
    """2, the part phase_k2 does not print: round 1's SMEMs on the first
    batch, and how many reach row 2^31 (k + s or l past it)."""
    import torch

    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.ops import smem_chain_cuda as k2

    opt = MemOptions()
    codes, lens = chip_smoke.first_batch(fq)
    q = torch.as_tensor(codes, device="cuda")
    lens_t = torch.as_tensor(lens, device="cuda")
    with keep_launches():
        got = k2.smem_round1_core(di, q, lens_t,
                                  min_seed_len=opt.min_seed_len,
                                  cap=opt.max_smems_per_read)
    M = got.k.shape[1]
    live = torch.arange(M, device="cuda")[None] < got.n.clamp(max=M)[:, None]
    k, s, l_ = got.k[live], got.s[live], got.l[live]
    high = (k + s > 1 << 31) | (l_ + s > 1 << 31)
    out = dict(smems=int(live.sum()), reaching_2_31=int(high.sum()),
               max_row=int(torch.maximum(k + s, l_ + s).max()))
    print(f"[big] K2 round 1: {out['smems']} SMEMs, {out['reaching_2_31']} "
          f"with an interval reaching row 2^31 (rows up to "
          f"{out['max_row']})")
    check(out["reaching_2_31"] > 0, "K2 met intervals past 2^31")
    return out


def k5(di, ss, idx) -> dict:
    """3: K5 == plain == the full SA on edge and random rows."""
    import torch

    from tpubwa_torch.ops.fm import sa_lookup_sampled
    from tpubwa_torch.ops.sa_sampled_cuda import sa_lookup_sampled_core

    n = di.sa.numel()                                    # rows 0 .. N
    gen = torch.Generator(device="cuda").manual_seed(SHIFT)
    longest = torch.nonzero(di.sa[:1 << 28] % (1 << SHIFT)
                            == (1 << SHIFT) - 1)[:1000, 0]
    p = int(idx.primary)
    ends = torch.tensor([0, n - 1, p - 1, p, p + 1], device="cuda")
    rand = torch.randint(0, n, (1 << 20,), device="cuda", generator=gen)
    rows = torch.cat([longest, ends, rand])
    want = di.sa[rows]
    with keep_launches():
        got = sa_lookup_sampled_core(di, ss, rows, SHIFT)
        plain, plain_ms = _timed(lambda: sa_lookup_sampled(di, ss, rows,
                                                           SHIFT))
        check(torch.equal(got, plain) and torch.equal(got, want),
              "K5 == plain == the full SA")
        ms = _cuda_ms(lambda: sa_lookup_sampled_core(di, ss, rows, SHIFT),
                      reps=10)
        card = chip_smoke.k5_card(di, ss, rows, SHIFT)
    b = chip_smoke.k5_bound(di, ss, rows, got, SHIFT, rows.numel())
    out = dict(rows=rows.numel(), above_2_31=int((want >= 1 << 31).sum()),
               ms=ms, plain_ms=plain_ms, steps=b["steps"],
               bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    print(f"[big] K5 at shift {SHIFT}: {out['rows']} rows ({out['above_2_31']}"
          f" of them at SA values >= 2^31) == plain == the full SA; kernel "
          f"{ms:.4f} ms ({card}), plain {plain_ms:.3f} ms; {b['steps']} LF "
          f"steps: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({100 * b['bound_ms'] / ms:.1f}% of it reached)")
    return out


def gathers(di) -> dict:
    """4: one dependent gather over tables of GB."""
    import torch

    from tpubwa_torch.utils.gather_latency import measure

    out = {}
    for name, t in (("wide checkpoints", di.cp),
                    ("SA", di.sa[:di.sa.numel() // 4 * 4])):
        table = t.view(torch.int32).view(-1, 8)
        for r in measure(table):
            out[f"{name}: {r['what']}"] = r["us_per_step"]
            print(f"[big] dependent loads over {r['rows']} rows "
                  f"({r['table_bytes']} bytes) of the {name}, {r['what']}: "
                  f"{r['us_per_step']:.3f} us = {r['cycles_per_step']:.0f} "
                  "cycles a step")
    return out


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1:
        print("usage: python3 chip_big.py DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_big: torch sees no CUDA device", file=sys.stderr)
        return 1
    from tpubwa_torch.align.pipeline import build_kernels
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa
    from tpubwa_torch.tools import big

    work, ref_len = argv[0], big.REF_LEN
    card = big.card_line()
    check(card is not None, "nvidia-smi reads the card's name and limit")
    print(card)
    t0 = time.monotonic()
    fa, fq = big.paths(work, ref_len, big.N_READS)
    res = dict(card=card, ref_len=ref_len, bodies=serve_records(work,
                                                                ref_len))
    build_kernels(sampled=True)
    res["k2"] = chip_smoke.phase_k2({"big": (fa, fq)}, prefix="big",
                                    layouts=(True,))["big"]
    idx = FMIndex.load(fa)
    di = DeviceIndex.from_host(idx, "cuda")
    check(di.cp.dtype == torch.int64 and int(di.L2[4]) >= 1 << 31,
          "the index is wide, its text past 2^31")
    res["k2_round1"] = high_intervals(di, fq)
    ss = build_sampled_sa(None, SHIFT, True, idx=idx, device="cuda")
    res["k5"] = k5(di, ss, idx)
    del ss
    res["gather_us"] = gathers(di)
    res["seconds"] = time.monotonic() - t0
    print(f"[big] all checks passed in {res['seconds']:.1f} s")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
