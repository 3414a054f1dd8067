"""Command-line interface of the PyTorch port: ``tpu-bwa-torch index|mem``.

  tpu-bwa-torch index <ref.fa>
  tpu-bwa-torch mem [--device cuda|DEV,DEV,...] [--preset P]
                    [--ext-layout t|b] [-k minSeedLen] [-t N] [--batch B]
                    [--sa-shift S] [--chunks DIR]
                    [--hosts N --host-id H [--coordinator ADDR:PORT]]
                    [--profile DIR] <ref.fa> reads.fq [mates.fq] > out.sam

``mem`` runs on ``--device`` (default ``cuda``; it fails when no GPU is
visible — pass ``--device cpu`` to run on the CPU).  A device mesh splits
each read batch over several devices: ``--preset v5e-4`` (4) or
``v5e-16`` (16) on ``--device cuda`` takes ``cuda:0`` .. ``cuda:N-1`` and
fails when fewer cards are visible, on ``--device cpu`` N CPU shards; a
comma-separated ``--device`` list is the mesh as given (it may name one
card several times) and must match the preset's size.  A second reads
file aligns paired ends.  ``--ext-layout`` picks the extension kernel: ``t``
(a group of lanes per job, the default) or ``b`` (one warp per job); the
output is the same.  The index format on disk is the JAX package's
(an index written by either package loads in the other); an index of
2^31 characters or more loads in the wide (int64) layout.  None of the
serving options changes the SAM.  ``--coordinator`` joins the ``--hosts``
processes in a ``torch.distributed`` gloo group, as the JAX CLI joins
them with ``jax.distributed``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import tpubwa_torch


def cmd_index(args) -> int:
    from tpubwa_torch.index.fmindex import FMIndex

    if not os.path.exists(args.ref):
        print(f"tpu-bwa-torch index: no such file: {args.ref}",
              file=sys.stderr)
        return 1
    t0 = time.monotonic()
    print(f"[tpu-bwa-torch] building FM-index for {args.ref}",
          file=sys.stderr)
    idx = FMIndex.from_fasta(args.ref)
    idx.save(args.ref)
    print(f"[tpu-bwa-torch] index built: l_pac={idx.l_pac} "
          f"seq_len={idx.seq_len} contigs={len(idx.contigs)} in "
          f"{time.monotonic() - t0:.2f}s", file=sys.stderr)
    return 0


def cmd_mem(args) -> int:
    from tpubwa_torch.align.pipeline import align_fastq
    from tpubwa_torch.parallel.mesh import DevicesUnavailable

    for f in [args.ref, args.reads1] + ([args.reads2] if args.reads2
                                         else []):
        if not os.path.exists(f):
            print(f"tpu-bwa-torch mem: no such file: {f}", file=sys.stderr)
            return 1
    shard = None
    if args.hosts:
        if not args.chunks:
            print("tpu-bwa-torch mem: --hosts requires --chunks DIR",
                  file=sys.stderr)
            return 1
        if not 0 <= args.host_id < args.hosts:
            print("tpu-bwa-torch mem: --host-id must be in [0, --hosts)",
                  file=sys.stderr)
            return 1
        shard = (args.host_id, args.hosts)
    # (a namespace a caller builds by hand may lack --coordinator)
    group = _join_hosts(getattr(args, "coordinator", None), args.hosts,
                        args.host_id)
    kw = dict(
        ref=args.ref, fq1=args.reads1, fq2=args.reads2, out=sys.stdout,
        device=args.device, min_seed_len=args.k, threads=args.t,
        batch_reads=args.batch, preset=args.preset, chunk_dir=args.chunks,
        sa_sample_shift=args.sa_shift, cmdline=" ".join(sys.argv),
        shard=shard, ext_layout=args.ext_layout)
    # a malformed input or option, and a mesh larger than the visible
    # cards, is one line and exit code 1; a refused manifest, a missing
    # GPU or a failed build (RuntimeError) stays loud
    try:
        if args.profile:
            return _profiled(args.profile, args.device, kw)
        return align_fastq(**kw)
    except (ValueError, DevicesUnavailable) as e:
        print(f"tpu-bwa-torch mem: {e}", file=sys.stderr)
        return 1
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_hosts(coordinator: str | None, hosts: int | None,
                host_id: int) -> bool:
    """With ``--hosts`` and ``--coordinator ADDR:PORT``, join this host
    process to the gloo process group of the run; returns whether it
    joined."""
    if not (hosts and coordinator):
        return False
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=hosts, rank=host_id)
    return True


def _profiled(trace_dir: str, device: str, kw: dict) -> int:
    """Run align_fastq under torch.profiler (CPU activity, plus CUDA
    activity on a CUDA device) and write its Chrome trace into
    `trace_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpubwa_torch.align.pipeline import align_fastq
    from tpubwa_torch.parallel.mesh import make_mesh

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in make_mesh(None, device).devices):
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        rc = align_fastq(**kw)
        if ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"tpu-bwa-torch.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    print(f"[tpu-bwa-torch] trace written to {path}", file=sys.stderr)
    return rc


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-bwa-torch",
        description="short-read aligner (PyTorch/CUDA port of tpu-bwa)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build FM-index for a FASTA reference")
    pi.add_argument("ref")
    pi.set_defaults(fn=cmd_index)

    pm = sub.add_parser("mem", help="align FASTQ reads, write SAM to stdout")
    pm.add_argument("--device", default="cuda",
                    help="torch device to align on (default: cuda), or a "
                         "comma-separated list of devices: a device mesh "
                         "that splits each read batch")
    pm.add_argument("--ext-layout", default="t", choices=["t", "b"],
                    help="extension kernel: t = a group of lanes per job "
                         "(default), b = a warp per job; the output is the "
                         "same")
    pm.add_argument("-t", type=int, default=1,
                    help="host worker threads: N > 1 aligns whole batches "
                         "in N threads, written in input order")
    pm.add_argument("-k", type=int, default=19, help="minimum seed length")
    pm.add_argument("--batch", type=int, default=None,
                    help="reads per device batch")
    pm.add_argument("--preset", default=None,
                    choices=["cpu-dev", "v5e-1", "v5e-4", "v5e-16"],
                    help="batch-size preset; v5e-4 and v5e-16 also set a "
                         "device mesh of 4 and 16 devices")
    pm.add_argument("--chunks", default=None, metavar="DIR",
                    help="persist each batch's SAM as an idempotent chunk "
                         "file in DIR; re-running resumes from completed "
                         "chunks (restartable output)")
    pm.add_argument("--sa-shift", type=int, default=0, metavar="S",
                    help="sampled-SA serving: keep 1/2^S of the suffix "
                         "array on the device and LF-walk the rest (exact "
                         "results)")
    pm.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR")
    pm.add_argument("--hosts", type=int, default=None, metavar="N",
                    help="multi-host scale-out: total number of host "
                         "processes; each aligns its share of the read "
                         "batches into the shared --chunks DIR (cat "
                         "DIR/chunk_*.sam reproduces the single-host SAM "
                         "body)")
    pm.add_argument("--host-id", type=int, default=0, metavar="H",
                    help="this process's id in [0, --hosts)")
    pm.add_argument("--coordinator", default=None, metavar="ADDR:PORT",
                    help="with --hosts: join the host processes in a "
                         "torch.distributed gloo group at tcp://ADDR:PORT")
    pm.add_argument("ref")
    pm.add_argument("reads1")
    pm.add_argument("reads2", nargs="?", default=None,
                    help="second reads file (paired ends)")
    pm.set_defaults(fn=cmd_mem)

    pv = sub.add_parser("version")
    pv.set_defaults(fn=lambda a: (print(tpubwa_torch.__version__), 0)[1])

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
