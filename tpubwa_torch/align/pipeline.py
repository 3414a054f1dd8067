"""End-to-end alignment pipeline on a torch device (port of
``tpubwa.align.pipeline``): FASTQ -> device seeding -> native chaining ->
device extension waves -> native finalize -> flat SAM; paired ends add
pairing and mate rescue (``align/pair.py``).

Phase timers keep the reference's names (SMEM / SAL / CHAIN / BSW / SAM).
Everything on the device runs on the Aligner's explicit ``device``; the
native host library (``tpubwa_torch/native``) is required.

Serving modes: a wide (>= 2^31) index, the sampled suffix array
(``opt.sa_sample_shift``), ``--chunks`` resume, ``--hosts`` sharding and
the ``-t N`` ordered worker pool.
"""
from __future__ import annotations

import sys
import threading

import numpy as np
import torch

import tpubwa_torch
from tpubwa_torch.align import flatext, flatsam
from tpubwa_torch.align.cigar_batch import GABatchExecutor
from tpubwa_torch.config import MemOptions
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fastq import stream_batches
from tpubwa_torch.io.sam import sam_header
from tpubwa_torch.native import load_native
from tpubwa_torch.ops import (extend_cuda, global_align_cuda, localsw_cuda,
                              sa_sampled_cuda, smem_chain_cuda)
from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
from tpubwa_torch.ops.fm import DeviceIndex, build_sampled_sa
from tpubwa_torch.ops.seeds import seed_rows
from tpubwa_torch.ops.smem_chain import collect_smems_chain
from tpubwa_torch.utils.timers import PhaseTimers


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpubwa_torch yet (ROADMAP.md queue 1, "
        f"item {item}); the JAX package tpubwa runs it")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must be visible (there is
    no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           "CUDA device")
    return dev


# the extension kernel per layout: "t" is K1 (a group of lanes per job,
# sized by the job), "b" is K1b (a warp per job); both compute the same
# function
EXT_CORES = {"t": extend_core, "b": extend_core_b}
_EXT_SOURCES = {"t": "extend", "b": "extend_b"}


class Aligner:
    """Holds the loaded index (host + device) and aligns read batches on
    one torch device.  ``ext_layout`` picks the extension kernel
    (``EXT_CORES``); the output does not depend on it.

    A wide index (seq_len + 1 >= 2^31) gets the int64 device layout.
    ``opt.sa_sample_shift = S`` keeps 1/2^S of the suffix array on the
    device (``self.ss``) and resolves seed positions by an LF-walk (K5).
    On a CUDA device every kernel the aligner can launch is built before
    the constructor returns, so ``-t N`` worker threads never build."""

    def __init__(self, idx: FMIndex, opt: MemOptions | None = None, *,
                 device, ext_layout: str = "t"):
        if ext_layout not in EXT_CORES:
            raise ValueError(f"ext_layout {ext_layout!r}: choose from "
                             f"{sorted(EXT_CORES)}")
        self.idx = idx
        self.opt = opt or MemOptions()
        if self.opt.mesh_shape:
            raise _not_ported("a device mesh (mesh_shape)", "P9")
        if self.opt.sa_sample_shift and self.opt.shard_sa:
            raise ValueError("sa_sample_shift and shard_sa are exclusive "
                             "SA serving modes")
        if self.opt.shard_sa:
            raise _not_ported("the sharded suffix array (shard_sa)", "P9")
        self.device = resolve_device(device)
        load_native()                 # fail now, not mid-batch
        self.mat = self.opt.score_matrix()
        self.contig_offsets = np.array([c.offset for c in idx.contigs],
                                       dtype=np.int64)
        # under a sampled SA the full-resolution device SA is never built
        self.di = DeviceIndex.from_host(
            idx, self.device, sa_stub=bool(self.opt.sa_sample_shift))
        self.ss = None
        if self.opt.sa_sample_shift:
            self.ss = build_sampled_sa(
                None, self.opt.sa_sample_shift,
                self.di.cp.dtype == torch.int64, idx=idx, device=self.device)
        self.ext_core = EXT_CORES[ext_layout]
        self.n_overflow = 0  # reads whose SMEM/seed buffers overflowed
        self._ovf_lock = threading.Lock()  # -t workers share this Aligner
        if self.device.type == "cuda":
            extend_cuda.build(_EXT_SOURCES[ext_layout])
            localsw_cuda.build()
            smem_chain_cuda.build()
            global_align_cuda.build()
            if self.opt.sa_sample_shift:
                sa_sampled_cuda.build()
        self.mat_dev = self._put(self.mat)
        self.ga_exec = GABatchExecutor(self.opt, put=self._put)
        self.timers = PhaseTimers()

    def _put(self, arr) -> torch.Tensor:
        """Host array -> tensor on the aligner's device."""
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    # ------------------------------------------------ device seeding ----

    def seed_batch_dispatch(self, codes: np.ndarray, lens: np.ndarray):
        """Run device seeding (SMEMs + seed rows) for a read batch; returns
        a handle for seed_batch_finish."""
        opt = self.opt
        with self.timers.phase("SMEM"):
            codes_dev = self._put(np.asarray(codes, np.int32))
            lens_dev = self._put(np.asarray(lens, np.int32))
            sm = collect_smems_chain(
                self.di, codes_dev, lens_dev,
                min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
                out_cap=opt.max_smems_per_read)
            cs = seed_rows(self.di, sm, max_occ=opt.max_occ,
                           per_read_cap=opt.max_seeds_per_read, ss=self.ss,
                           sa_shift=opt.sa_sample_shift)
        return cs, sm.overflow, codes_dev, lens_dev

    def seed_batch_finish(self, handle):
        """Download a seeding handle's results: (seed_rows [n, 4] =
        (read_id, rbeg, qbeg, len), l_rep [B])."""
        cs, sm_ovf = handle[0], handle[1]
        with self.timers.phase("SAL"):
            n = int(cs.n)
            l_rep = cs.l_rep.cpu().numpy()
            n_ovf = int((sm_ovf | cs.overflow).sum())
            if n_ovf:
                with self._ovf_lock:
                    self.n_overflow += n_ovf
                print(f"[tpu-bwa-torch] warning: {n_ovf} read(s) exceeded "
                      "SMEM/seed buffer caps; their seed lists were "
                      "truncated", file=sys.stderr)
            rows = cs.packed[:n].cpu().numpy()
        return rows, l_rep

    # ------------------------------------------ flat extension path ----

    def _regions_flat(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch via the flat native engine;
        returns (fields, bounds) as ``flatext.finalize_fields`` gives
        them."""
        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        seed_rows_h, l_rep = self.seed_batch_finish(seed_handle)
        codes_dev, lens_dev = seed_handle[2], seed_handle[3]

        B = batch.n
        with self.timers.phase("CHAIN"):
            bounds = np.searchsorted(seed_rows_h[:, 0], np.arange(B + 1))
            skip = (np.asarray(batch.lens) < self.opt.min_seed_len
                    ).astype(np.uint8)
            handle, jobs, n_jobs = flatext.prepare_jobs(
                self.opt, self.idx.l_pac, self.contig_offsets, seed_rows_h,
                bounds, skip, batch.lens, l_rep[:B])
        with self.timers.phase("BSW"):
            results = flatext.run_phased(self, codes_dev, lens_dev, handle,
                                         jobs, n_jobs, lens_host=batch.lens)
            return flatext.finalize_fields(handle, results, B, n_jobs)

    def regions_batch(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch; returns list[list[AlnReg]]."""
        fields, fbounds = self._regions_flat(batch, seed_handle=seed_handle)
        return [flatsam._alnregs_for(fields, fbounds, b)
                for b in range(batch.n)]

    # ------------------------------------------------ full batch ----

    def align_se_text(self, batch, read_id0: int, seed_handle=None) -> str:
        """Align a ReadBatch single-end; returns SAM text (flat columnar
        finalize, align/flatsam.py)."""
        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        fields, fbounds = self._regions_flat(batch, seed_handle=seed_handle)
        with self.timers.phase("SAM"):
            return flatsam.se_text_batch(self, batch, read_id0, fields,
                                         fbounds, codes_dev=seed_handle[2])


def align_fastq(ref: str, fq1: str, fq2: str | None, out, *, device="cuda",
                min_seed_len: int = 19, threads: int = 1,
                batch_reads: int | None = None, preset: str | None = None,
                chunk_dir: str | None = None,
                cmdline: str = "tpu-bwa-torch mem",
                shard: tuple[int, int] | None = None,
                sa_sample_shift: int = 0, ext_layout: str = "t") -> int:
    """CLI entry: align a FASTQ (or a pair of them) against an indexed
    reference on `device`, write SAM to `out`.  Returns 0, or 1 when the
    index is missing or paired FASTQs differ in read count.

    ``threads`` workers run the ordered pool (1: the dispatch-ahead
    driver); ``chunk_dir`` persists each batch as a chunk file and resumes
    from the ones present; ``shard=(host_id, n_hosts)`` aligns only this
    host's batches (it needs ``chunk_dir``, where the hosts meet)."""
    if shard is not None and not chunk_dir:
        raise ValueError("multi-host sharding requires --chunks DIR "
                         "(hosts meet in the shared chunk directory)")
    if not FMIndex.exists(ref):
        print(f"[tpu-bwa-torch] no index for {ref}; run `tpu-bwa-torch "
              "index` first", file=sys.stderr)
        return 1
    if preset:
        opt = MemOptions.preset(preset, min_seed_len=min_seed_len)
    else:
        opt = MemOptions(min_seed_len=min_seed_len)
    if batch_reads is not None:
        opt.batch_reads = int(batch_reads)
    if sa_sample_shift:
        opt.sa_sample_shift = int(sa_sample_shift)
    idx = FMIndex.load(ref)
    aligner = Aligner(idx, opt, device=device, ext_layout=ext_layout)
    print(f"[tpu-bwa-torch] device {aligner.device} "
          f"(batch {opt.batch_reads}, extension layout {ext_layout})",
          file=sys.stderr)
    out.write(sam_header(idx.contigs, cmdline, tpubwa_torch.__version__))
    manifest = _run_manifest(ref, fq1, fq2, opt) if chunk_dir else None
    kw = dict(workers=threads, chunk_dir=chunk_dir, manifest=manifest,
              shard=shard)
    if fq2 is not None:
        from tpubwa_torch.align.pair import align_pe_fastq

        return align_pe_fastq(aligner, fq1, fq2, out, **kw)
    run_se_pipeline(aligner, fq1, out, **kw)
    print(aligner.timers.report(), file=sys.stderr)
    return 0


def _run_manifest(ref: str, fq1: str, fq2: str | None,
                  opt: MemOptions) -> dict:
    """Identity of an alignment run for --chunks resume validation: the
    inputs (path + size + mtime) and every option that affects chunk
    boundaries or content."""
    import dataclasses
    import os

    def fid(p):
        st = os.stat(p)
        return [os.path.abspath(p), st.st_size, st.st_mtime]

    return {
        "ref": fid(ref),
        "fq1": fid(fq1),
        "fq2": fid(fq2) if fq2 else None,
        "opt": {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(opt).items()},
    }


def _check_chunk_manifest(chunk_dir: str, manifest: dict | None) -> None:
    """Refuse to resume from chunks produced under a different run identity
    (input files, batch size, alignment options): stale chunk files would be
    spliced into the output verbatim and silently corrupt the SAM."""
    import json
    import os

    if manifest is None:
        return
    path = os.path.join(chunk_dir, "manifest.json")
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev != manifest:
            raise RuntimeError(
                f"chunk dir {chunk_dir} was written by a different run "
                f"(manifest mismatch); delete it or point --chunks at a "
                f"fresh directory.\n  existing: {prev}\n  current:  "
                f"{manifest}")
    else:
        # unique per process and thread: --hosts processes that start
        # together all find no manifest and all write it
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)


def run_ordered_pool(items, work, out, workers: int, label: str = "reads",
                     chunk_dir: str | None = None,
                     manifest: dict | None = None,
                     shard: tuple[int, int] | None = None) -> int:
    """Generic pipelined driver: a reader thread streams work items,
    ``workers`` threads each process whole items (device calls from all
    workers interleave on the device's stream while host Python of one
    item overlaps device waits of another), and a writer emits results
    strictly in input order so output is deterministic regardless of
    scheduling.

    ``items`` yields (payload, n_units); ``work(payload) -> text``.

    With ``chunk_dir`` set, each work item's output is also persisted as an
    idempotent chunk file (atomic tmp+rename); items whose chunk already
    exists are NOT recomputed — re-running an interrupted command resumes
    from the completed chunks.  ``manifest`` identifies the run (inputs +
    options); resuming from a chunk dir whose manifest differs is an error.

    ``shard=(host_id, n_hosts)`` is the multi-host scale-out mode: this
    process only computes items with global_seq % n_hosts == host_id, but
    chunk files keep their GLOBAL sequence numbers — when every host has
    finished against the same chunk_dir, concatenating chunk_*.sam in name
    order reproduces the single-host output exactly."""
    import heapq
    import os
    import queue

    if chunk_dir:
        os.makedirs(chunk_dir, exist_ok=True)
        _check_chunk_manifest(chunk_dir, manifest)

    def chunk_path(seq: int) -> str:
        return os.path.join(chunk_dir, f"chunk_{seq:06d}.sam")

    workers = max(1, int(workers))
    in_q: "queue.Queue" = queue.Queue(maxsize=workers + 1)
    out_q: "queue.Queue" = queue.Queue(maxsize=workers * 2 + 2)
    err: list[BaseException] = []
    stop = threading.Event()  # set on any worker/reader error
    n_done = 0
    done_lock = threading.Lock()

    def reader():
        try:
            lseq = 0
            for gseq, (payload, n_units) in enumerate(items):
                if stop.is_set():
                    break
                if shard is not None and gseq % shard[1] != shard[0]:
                    continue  # another host's item
                # bounded put that stays responsive to worker errors: if
                # every worker died the queue never drains and a plain
                # put() would deadlock the whole pool
                while True:
                    try:
                        in_q.put((lseq, gseq, payload, n_units),
                                 timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
                lseq += 1
        except BaseException as e:  # propagate to main
            err.append(e)
            stop.set()
        finally:
            for _ in range(workers):
                while True:
                    try:
                        in_q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            # drain so the sentinel fits; workers are dead
                            try:
                                in_q.get_nowait()
                            except queue.Empty:
                                pass

    def worker():
        nonlocal n_done
        while True:
            item = in_q.get()
            if item is None:
                out_q.put(None)
                return
            seq, gseq, payload, n_units = item
            try:
                if chunk_dir and os.path.exists(chunk_path(gseq)):
                    with open(chunk_path(gseq)) as f:  # resume: reuse chunk
                        text = f.read()
                else:
                    text = work(payload)
                    if chunk_dir:
                        tmp = chunk_path(gseq) + ".tmp"
                        with open(tmp, "w") as f:
                            f.write(text)
                        os.replace(tmp, chunk_path(gseq))  # atomic publish
            except BaseException as e:
                err.append(e)
                stop.set()
                out_q.put(None)
                return
            with done_lock:
                n_done += n_units
                print(f"[tpu-bwa-torch] {n_done} {label} processed",
                      file=sys.stderr)
            out_q.put((seq, text))

    def writer():
        heap: list = []
        want = 0
        ended = 0
        while ended < workers:
            item = out_q.get()
            if item is None:
                ended += 1
                continue
            heapq.heappush(heap, item)
            while heap and heap[0][0] == want:
                _, text = heapq.heappop(heap)
                out.write(text)
                want += 1
        while heap:  # error path: drain what completed
            _, text = heapq.heappop(heap)
            out.write(text)

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    ws = [threading.Thread(target=worker, daemon=True)
          for _ in range(workers)]
    rt.start()
    for w in ws:
        w.start()
    wt.start()
    wt.join()
    rt.join()
    for w in ws:
        w.join()
    if err:
        raise err[0]
    return n_done


def run_dispatch_ahead(items, dispatch, work, out,
                       chunk_dir: str | None = None,
                       manifest: dict | None = None,
                       shard: tuple[int, int] | None = None) -> int:
    """The single-thread dispatch-ahead driver of SE and PE: item N+1's
    device seeding (``dispatch(payload) -> handle``) is issued before item
    N is finished (``work(payload, handle) -> text``, written to `out`).
    ``items`` yields (payload, n_units); returns the units done.

    ``chunk_dir``, ``manifest`` and ``shard`` behave as in
    ``run_ordered_pool``: an item whose chunk file exists is neither
    dispatched nor aligned (its chunk is written out as it is), and only
    this host's items (global number % n_hosts == host_id) are taken.

    If the reader raises, the pending item is finished and written
    first, then the error propagates."""
    import os

    if chunk_dir:
        os.makedirs(chunk_dir, exist_ok=True)
        _check_chunk_manifest(chunk_dir, manifest)

    def chunk_path(seq: int) -> str:
        return os.path.join(chunk_dir, f"chunk_{seq:06d}.sam")

    n_done = 0

    def finish(gseq, payload, n_units, handle) -> None:
        nonlocal n_done
        if handle is None:  # resume: the chunk is on disk
            with open(chunk_path(gseq)) as f:
                text = f.read()
        else:
            text = work(payload, handle)
            if chunk_dir:
                tmp = chunk_path(gseq) + ".tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, chunk_path(gseq))  # atomic publish
        out.write(text)
        n_done += n_units
        print(f"[tpu-bwa-torch] {n_done} reads processed", file=sys.stderr)

    pend = None  # (gseq, payload, n_units, handle | None)
    it = enumerate(items)
    while True:
        try:
            gseq, (payload, n_units) = next(it)
        except StopIteration:
            break
        except Exception:
            if pend is not None:
                finish(*pend)
            raise
        if shard is not None and gseq % shard[1] != shard[0]:
            continue  # another host's item
        handle = (None if chunk_dir and os.path.exists(chunk_path(gseq))
                  else dispatch(payload))
        if pend is not None:
            finish(*pend)
        pend = (gseq, payload, n_units, handle)
    if pend is not None:
        finish(*pend)
    return n_done


def run_se_pipeline(aligner: Aligner, fq1: str, out, workers: int = 1,
                    chunk_dir: str | None = None,
                    manifest: dict | None = None,
                    shard: tuple[int, int] | None = None) -> int:
    """SE driver.  ``workers == 1`` runs ``run_dispatch_ahead``: batch
    N+1's seeding is issued before batch N is finished (seeding reads its
    round-2 candidate count on the host, so rounds 1 and 2 complete
    before it returns; only round 3 and the seed rows overlap batch N).
    ``workers > 1`` runs the ordered thread pool, each worker aligning
    whole batches.  Returns the reads done."""
    opt = aligner.opt

    def items():
        read_id0 = 0
        for batch in stream_batches(fq1, opt.batch_reads, opt.max_read_len):
            yield (batch, read_id0), batch.n
            read_id0 += batch.n

    def dispatch(payload):
        return aligner.seed_batch_dispatch(payload[0].codes, payload[0].lens)

    def work(payload, handle=None) -> str:
        batch, read_id0 = payload
        return aligner.align_se_text(batch, read_id0, seed_handle=handle)

    kw = dict(chunk_dir=chunk_dir, manifest=manifest, shard=shard)
    if workers <= 1:
        return run_dispatch_ahead(items(), dispatch, work, out, **kw)
    return run_ordered_pool(items(), work, out, workers, **kw)
