"""Build and serve a genome of real size: ``python -m tpubwa_torch.tools.big``.

The port of the JAX package's ``scripts/build_big.py`` and
``scripts/run_big.py`` as one entry point.  The default is their run: a
1.2 Gbp realistic synthetic genome (``utils.gensim``, seed 1234; contig
``bigsynth``), whose index text of 2.4 x 10^9 characters is wide (>= 2^31),
served from one device at ``--sa-shift 5``.

  python -m tpubwa_torch.tools.big [--ref-len N] [--sa-shift S]
                                   [--n-reads N] [--device cuda|cpu]
                                   [--work DIR]

Build step (skipped for what ``--work`` already holds): the genome and its
FASTA, the index (``read_fasta`` + ``FMIndex.build``, which is
``FMIndex.from_fasta``), saved beside the FASTA; ``--n-reads`` reads of 150
bp at 1 % error (``sim.simulate_reads``, seed 17).  Its record has
``gen_s``, ``write_s``, ``index_build_s``, ``save_s``, ``wide``,
``seq_len``, ``peak_rss_gb`` and ``npz_gb``, as ``BUILD_BIG.json``.

Serve step: the index is loaded, put on ``--device`` (``--sa-shift 0``:
the full SA) and the reads aligned twice (``run_se_pipeline``,
``BATCH_READS`` reads a batch).  Its record has the fields of
``BENCH_r05_big.json`` (``index_load_s``, ``device_setup_s``,
``first_pass_s``, ``sam_records``, ``warm_pass_s``,
``reads_per_sec_warm``, ``mapped_near_truth_frac``) and
``device_bytes``, ``card`` and ``sam_body_sha256``.  ``sam_records``
counts every line the pipeline writes (it writes no header), and
``mapped_near_truth_frac`` is the share of those lines placed within 50 bp
of the position in the read's name, as ``run_big.py`` counts them.

Both records are printed as JSON lines (the serve record last) and written
to ``--work`` as ``build_<ref_len>.json`` (merged into what an earlier run
wrote there) and ``serve_<ref_len>_s<shift>.json``.  ``--device cuda``
(the default) raises when torch sees no GPU; it never falls back to the
CPU.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import io
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ_LEN, READ_ERR, READ_SEED, GENOME_SEED = 150, 0.01, 17, 1234
REF_LEN, N_READS = 1_200_000_000, 20_000      # run_big.py's run
BATCH_READS = 8192      # run_big.py's batch: the size of every batch's buffers


def _peak_rss_gb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)


def paths(work: str, ref_len: int, n_reads: int) -> tuple[str, str]:
    """(FASTA, FASTQ) of a run in `work`."""
    return (os.path.join(work, f"ref_{ref_len}_big.fa"),
            os.path.join(work, f"reads_{ref_len}_{n_reads}.fq"))


def build(ref_len: int, n_reads: int, work: str) -> dict:
    """The build step; returns its record (the timings of the parts it
    ran this time)."""
    from tpubwa_torch.index.fmindex import INDEX_SUFFIX, FMIndex
    from tpubwa_torch.io.fasta import read_fasta
    from tpubwa_torch.ops.fm import wide_layout
    from tpubwa_torch.utils import gensim, sim

    os.makedirs(work, exist_ok=True)
    fa, fq = paths(work, ref_len, n_reads)
    rec: dict = {"ref_len": ref_len, "n_text": 2 * ref_len}
    if not os.path.exists(fa):
        t = time.monotonic()
        codes, n_mask = gensim.realistic_genome(
            np.random.default_rng(GENOME_SEED), ref_len)
        rec["gen_s"] = round(time.monotonic() - t, 1)
        t = time.monotonic()
        gensim.write_fasta(fa + ".part", codes, n_mask, name="bigsynth")
        os.replace(fa + ".part", fa)
        rec["write_s"] = round(time.monotonic() - t, 1)
        del codes, n_mask
    codes = contigs = None
    if not FMIndex.exists(fa):
        t = time.monotonic()
        contigs, codes, holes = read_fasta(fa)
        idx = FMIndex.build(contigs, codes, holes)
        rec["index_build_s"] = round(time.monotonic() - t, 1)
        t = time.monotonic()
        idx.save(fa)
        rec["save_s"] = round(time.monotonic() - t, 1)
        rec["wide"] = wide_layout(idx)
        rec["seq_len"] = idx.seq_len
        rec["peak_rss_gb"] = _peak_rss_gb()
        del idx, holes
        gc.collect()
    rec["npz_gb"] = round(os.path.getsize(fa + INDEX_SUFFIX + ".npz") / 1e9,
                          2)
    if not os.path.exists(fq):
        t = time.monotonic()
        if codes is None:
            contigs, codes, _ = read_fasta(fa)
        reads = sim.simulate_reads(codes, contigs, n_reads, length=READ_LEN,
                                   err=READ_ERR, seed=READ_SEED)
        sim.write_fastq(fq + ".part", reads)
        os.replace(fq + ".part", fq)
        rec["reads_s"] = round(time.monotonic() - t, 1)
    return rec


def near_truth(sam: str) -> tuple[int, int]:
    """(lines placed within 50 bp of their read's simulated position,
    lines): every record line, secondary and supplementary included."""
    ok = tot = 0
    for line in sam.splitlines():
        if not line.startswith("sim_"):
            continue
        f = line.split("\t")
        tot += 1
        ok += f[2] != "*" and abs(int(f[3]) - 1 - int(f[0].split("_")[3])) \
            <= 50
    return ok, tot


def card_line() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_bytes(aligner) -> dict:
    """Bytes of the index tensors and sampled-SA tables on the device."""
    di, ss = aligner.di, aligner.ss

    def nb(t):
        return t.numel() * t.element_size()

    out = {"cp": nb(di.cp), "sa": nb(di.sa), "pac": nb(di.pac_words),
           "sampled_sa": sum(nb(t) for t in ss) if ss is not None else 0}
    out["total"] = sum(out.values())
    return out


def serve(fa: str, fq: str, shift: int, n_reads: int, device,
          wide: bool | None = None, batch_reads: int = BATCH_READS
          ) -> tuple[dict, str]:
    """The serve step; returns its record and the SAM body.  ``wide``
    forces a layout (None: the index's own)."""
    from tpubwa_torch.align.pipeline import (Aligner, build_kernels,
                                             run_se_pipeline)
    from tpubwa_torch.config import MemOptions
    from tpubwa_torch.index.fmindex import FMIndex
    from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa
    from tpubwa_torch.parallel.mesh import resolve_device

    dev = resolve_device(device)
    rec: dict = {"sa_shift": shift, "n_reads": n_reads}
    if dev.type == "cuda":      # nvcc's time stays out of device_setup_s
        t = time.monotonic()
        build_kernels(sampled=bool(shift))
        rec["kernel_build_s"] = round(time.monotonic() - t, 1)
    t = time.monotonic()
    idx = FMIndex.load(fa)
    rec["ref_len"] = idx.l_pac
    rec["index_load_s"] = round(time.monotonic() - t, 1)
    t = time.monotonic()
    opt = MemOptions(sa_sample_shift=shift, batch_reads=batch_reads)
    al = Aligner(idx, opt, device=dev)
    if wide is not None and wide != (al.di.cp.dtype == torch.int64):
        al.di = DeviceIndex.from_host(idx, dev, wide=wide,
                                      sa_stub=bool(shift))
        if shift:
            al.ss = build_sampled_sa(None, shift, wide, idx=idx, device=dev)
    _sync(dev)
    rec["device_setup_s"] = round(time.monotonic() - t, 1)
    rec["wide"] = al.di.cp.dtype == torch.int64
    rec["device_bytes"] = device_bytes(al)

    def one_pass() -> tuple[str, float]:
        out = io.StringIO()
        _sync(dev)
        t = time.monotonic()
        run_se_pipeline(al, fq, out)
        _sync(dev)
        return out.getvalue(), time.monotonic() - t

    body, cold = one_pass()
    rec["first_pass_s"] = round(cold, 1)
    rec["sam_records"] = body.count("\n")
    al.timers = type(al.timers)()
    warm_body, warm = one_pass()
    if warm_body != body:
        raise RuntimeError("the warm pass wrote another SAM body than the "
                           "first")
    rec["warm_pass_s"] = round(warm, 3)
    rec["reads_per_sec_warm"] = round(n_reads / warm, 1)
    ok, tot = near_truth(body)
    rec["mapped_near_truth_frac"] = round(ok / max(tot, 1), 4)
    rec["sam_body_sha256"] = hashlib.sha256(body.encode()).hexdigest()
    rec["phases_warm_s"] = {k: round(v, 3)
                            for k, v in al.timers.totals.items()}
    rec["peak_rss_gb"] = _peak_rss_gb()
    rec["card"] = card_line() if dev.type == "cuda" else None
    return rec, body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.big",
        description="Build a realistic synthetic genome of real size and "
        "serve it on one device.")
    ap.add_argument("--ref-len", type=int, default=REF_LEN)
    ap.add_argument("--sa-shift", type=int, default=5,
                    help="sampled SA interval 2^S (0: the full SA)")
    ap.add_argument("--n-reads", type=int, default=N_READS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(ROOT, ".bench"))
    args = ap.parse_args(argv)
    from tpubwa_torch.parallel.mesh import resolve_device

    resolve_device(args.device)       # no GPU: fail before the build
    brec = build(args.ref_len, args.n_reads, args.work)
    print(json.dumps(brec), flush=True)
    path = os.path.join(args.work, f"build_{args.ref_len}.json")
    if os.path.exists(path):            # keep the timings of earlier runs
        with open(path) as f:
            brec = {**json.load(f), **brec}
    with open(path, "w") as f:
        json.dump(brec, f, indent=1)
    fa, fq = paths(args.work, args.ref_len, args.n_reads)
    srec, _ = serve(fa, fq, args.sa_shift, args.n_reads, args.device,
                    batch_reads=BATCH_READS)
    with open(os.path.join(args.work, f"serve_{args.ref_len}_s"
                           f"{args.sa_shift}.json"), "w") as f:
        json.dump(srec, f, indent=1)
    print(json.dumps(srec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
