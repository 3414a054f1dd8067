"""End-to-end alignment pipeline on a torch device (port of
``tpubwa.align.pipeline``): FASTQ -> device seeding -> native chaining ->
device extension waves -> native finalize -> flat SAM; paired ends add
pairing and mate rescue (``align/pair.py``).

Phase timers keep the reference's names (SMEM / SAL / CHAIN / BSW / SAM)
and name the host steps around them (FASTQ, WRITE, REGS, DEDUP;
``utils/timers``).
Everything on the device runs on the Aligner's explicit ``device``, one
device or a mesh of them (``parallel/mesh.py``); the native host library
(``tpubwa_torch/native``) is required.

Serving modes: a device mesh (``opt.mesh_shape``, the v5e-4/v5e-16
presets) with the suffix array copied or sharded (``opt.shard_sa``), a
wide (>= 2^31) index, the sampled suffix array (``opt.sa_sample_shift``),
``--chunks`` resume, ``--hosts`` sharding and the ``-t N`` ordered worker
pool.
"""
from __future__ import annotations

import sys
import threading
from typing import NamedTuple

import numpy as np
import torch

import tpubwa_torch
from tpubwa_torch.align import finalize, flatext, flatsam
from tpubwa_torch.align.chain import chain_filter_batch_native
from tpubwa_torch.align.cigar_batch import GABatchExecutor
from tpubwa_torch.align.region import (extend_read, read_regions,
                                       run_extension_rounds)
from tpubwa_torch.config import WIDE, MemOptions, batch_widths
from tpubwa_torch.index.fmindex import FMIndex
from tpubwa_torch.io.fastq import stream_batches
from tpubwa_torch.io.sam import sam_header
from tpubwa_torch.native import load_native
from tpubwa_torch.ops import (extend_cuda, global_align_cuda, localsw_cuda,
                              sa_sampled_cuda, smem_chain_cuda)
from tpubwa_torch.ops.extend import extend_seed_batch
from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
from tpubwa_torch.ops.fm import (DeviceIndex, ShardedSA, build_sampled_sa,
                                 wide_layout)
from tpubwa_torch.ops.seeds import seed_rows_mesh
from tpubwa_torch.ops.smem_chain import collect_smems_mesh
from tpubwa_torch.parallel.mesh import make_mesh, resolve_device  # noqa: F401
from tpubwa_torch.utils.rounds import drive_rounds
from tpubwa_torch.utils.timers import PhaseTimers, count


# the extension kernel per layout: "t" is K1 (a group of lanes per job,
# sized by the job), "b" is K1b (a warp per job); both compute the same
# function
EXT_CORES = {"t": extend_core, "b": extend_core_b}
_EXT_SOURCES = {"t": "extend", "b": "extend_b"}


def build_kernels(ext_layout: str = "t", sampled: bool = False) -> None:
    """Build the kernels a run on a card launches (nvcc, once a source):
    the extension layout's, K4, K2, K3, and K5 under a sampled SA."""
    extend_cuda.build(_EXT_SOURCES[ext_layout])
    localsw_cuda.build()
    smem_chain_cuda.build()
    global_align_cuda.build()
    if sampled:
        sa_sampled_cuda.build()


class SeedHandle(NamedTuple):
    """A batch's dispatched seeding (``Aligner.seed_batch_dispatch``)."""

    seeds: list         # CompactSeeds of each shard that has reads
    smem_ovf: list      # its SMEM buffer overflow flags [B_d]
    codes_dev: torch.Tensor  # the batch's codes (int32) on the first device
    lens_dev: torch.Tensor
    codes_on: dict      # device -> (codes, lens) of the whole batch
    starts: list        # the first read of each shard that has reads


class Aligner:
    """Holds the loaded index (host + device) and aligns read batches on
    one torch device or on a device mesh.  ``ext_layout`` picks the
    extension kernel (``EXT_CORES``); the output does not depend on it.

    ``device`` is one device, or a sequence of devices (or a
    comma-separated string) that is the mesh as given; with
    ``opt.mesh_shape`` set, a single ``"cpu"`` or ``"cuda"`` names N
    devices (``parallel.mesh.make_mesh``).  On a mesh each read batch is
    split into N contiguous slices: seeding (K2, and K5 under a sampled
    SA) and the extension waves (K1 or K1b) run on every shard; the host
    phases, the CIGAR program (K3) and mate rescue (K4) see the whole
    batch on the mesh's first device, where ``_put`` puts arrays.  The
    index is copied once to each distinct device (``self.di`` is the
    first device's copy); ``opt.shard_sa`` splits the suffix array over
    the mesh instead (``self.ssa``).

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
        if self.opt.sa_sample_shift and self.opt.shard_sa:
            raise ValueError("sa_sample_shift and shard_sa are exclusive "
                             "SA serving modes")
        self.mesh = make_mesh(int(np.prod(self.opt.mesh_shape))
                              if self.opt.mesh_shape else None, device)
        if self.opt.shard_sa and len(self.mesh) == 1:
            raise ValueError("shard_sa requires a device mesh "
                             "(set opt.mesh_shape or pass mesh=)")
        self.device = self.mesh[0]
        load_native()                 # fail now, not mid-batch
        self.mat = self.opt.score_matrix()
        self.contig_offsets = np.array([c.offset for c in idx.contigs],
                                       dtype=np.int64)
        wide = wide_layout(idx)
        shift = self.opt.sa_sample_shift
        # one copy of the index a distinct device; under a sampled or a
        # sharded SA the full-resolution SA is not copied
        copies = {}
        for dev in self.mesh.distinct:
            di = DeviceIndex.from_host(idx, dev, wide=wide,
                                       sa_stub=bool(shift) or
                                       self.opt.shard_sa)
            ss = (build_sampled_sa(None, shift, wide, idx=idx, device=dev)
                  if shift else None)
            copies[dev] = (di, ss)
        self.di, self.ss = copies.pop(self.device)
        self._copies = copies
        self.ssa = (ShardedSA.from_host(idx, self.mesh.devices, wide)
                    if self.opt.shard_sa else None)
        self.ext_core = EXT_CORES[ext_layout]
        self.n_overflow = 0  # reads whose SMEM/seed buffers overflowed
        self._ovf_lock = threading.Lock()  # -t workers share this Aligner
        # the kernels are one library a source for every card
        if any(dev.type == "cuda" for dev in self.mesh.distinct):
            build_kernels(ext_layout, sampled=bool(shift))
        self._mats = {dev: self._put(self.mat, dev)
                      for dev in self.mesh.distinct}
        self.mat_dev = self._mats[self.device]
        self.ga_exec = GABatchExecutor(self.opt, put=self._put)
        self.timers = PhaseTimers()

    def _put(self, arr, device=None) -> torch.Tensor:
        """Host array -> tensor on `device` (default: the first device of
        the mesh)."""
        return torch.as_tensor(np.ascontiguousarray(arr),
                               device=self.device if device is None
                               else device)

    def index_on(self, dev) -> tuple:
        """(DeviceIndex, SampledSA or None) on mesh device `dev`."""
        return (self.di, self.ss) if dev == self.device else \
            self._copies[dev]

    def mat_on(self, dev) -> torch.Tensor:
        """The scoring matrix on mesh device `dev`."""
        return self._mats[dev]

    def batch_on(self, codes_dev: torch.Tensor,
                 lens_dev: torch.Tensor) -> dict:
        """{device: (codes, lens)}: a batch on the first device, copied to
        each other distinct device of the mesh."""
        return {dev: (codes_dev.to(dev, non_blocking=True),
                      lens_dev.to(dev, non_blocking=True))
                for dev in self.mesh.distinct}

    # ------------------------------------------------ device seeding ----

    def seed_batch_dispatch(self, codes: np.ndarray,
                            lens: np.ndarray) -> SeedHandle:
        """Run device seeding (SMEMs + seed rows) for a read batch; returns
        a handle for seed_batch_finish.  The SMEM and seed capacities a
        read are the options' times the batch's bucket's ``seed_scale``,
        the batch's seed rows its ``seed_rows`` a read
        (``config.batch_widths`` of the codes' width).  On a mesh every
        shard's work is issued before anything is read back but the
        round-2 candidate counts; a shard without reads launches
        nothing."""
        opt = self.opt
        with self.timers.phase("SMEM"):
            codes32 = np.asarray(codes, np.int32)
            lens32 = np.asarray(lens, np.int32)
            wd = batch_widths(opt, codes32.shape[1])
            codes_on = {dev: (self._put(codes32, dev), self._put(lens32, dev))
                        for dev in self.mesh.distinct}
            # the reads before the batch's padding (rows of length 0 at
            # its end) are split evenly; the padding rides on the last
            # shard, so the batch's row cap counts it as one device does
            n = int(np.flatnonzero(lens32)[-1]) + 1 if lens32.any() else 0
            parts = self.mesh.split(n)
            parts[-1] = (parts[-1][0], len(lens32))
            shards = [(self.mesh[d], lo, hi)
                      for d, (lo, hi) in enumerate(parts) if hi > lo]
            idxs = [self.index_on(dev) for dev, _, _ in shards]
            sms = collect_smems_mesh(
                [di for di, _ in idxs],
                [codes_on[dev][0][lo:hi] for dev, lo, hi in shards],
                [codes_on[dev][1][lo:hi] for dev, lo, hi in shards],
                min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
                out_cap=opt.max_smems_per_read * wd.seed_scale)
            seeds = seed_rows_mesh(
                [di for di, _ in idxs], sms, max_occ=opt.max_occ,
                per_read_cap=opt.max_seeds_per_read * wd.seed_scale,
                rows_per_read=wd.seed_rows,
                sss=[ss for _, ss in idxs], sa_shift=opt.sa_sample_shift,
                ssa=self.ssa)
        return SeedHandle(seeds, [sm.overflow for sm in sms],
                          *codes_on[self.device], codes_on,
                          [lo for _, lo, _ in shards])

    def seed_batch_finish(self, handle: SeedHandle):
        """Download a seeding handle's results: (seed_rows [n, 4] =
        (read_id, rbeg, qbeg, len), l_rep [B]), the shards' rows merged
        in shard order with read ids of the batch.  Reads whose SMEM or
        seed list was cut to its capacity count in ``seed.overflow_reads``
        (and ``n_overflow``), with a warning."""
        with self.timers.phase("SAL"):
            ns = [int(cs.n) for cs in handle.seeds]
            l_rep = np.concatenate(
                [cs.l_rep.cpu().numpy() for cs in handle.seeds]
                + [np.zeros(0, np.int32)])
            n_ovf = sum(int((o | cs.overflow).sum())
                        for o, cs in zip(handle.smem_ovf, handle.seeds))
            if n_ovf:
                with self._ovf_lock:
                    self.n_overflow += n_ovf
                count(self.timers, "seed.overflow_reads", n_ovf)
                print(f"[tpu-bwa-torch] warning: {n_ovf} read(s) exceeded "
                      "SMEM/seed buffer caps; their seed lists were "
                      "truncated", file=sys.stderr)
            parts = []
            for cs, n, lo in zip(handle.seeds, ns, handle.starts):
                rows = cs.packed[:n].cpu().numpy()
                rows[:, 0] += lo
                parts.append(rows)
            rows = (np.concatenate(parts) if parts
                    else np.zeros((0, 4), np.int32))
        return rows, l_rep

    def seed_batch(self, codes: np.ndarray, lens: np.ndarray):
        """Synchronous dispatch + finish."""
        return self.seed_batch_finish(self.seed_batch_dispatch(codes, lens))

    # ------------------------------------------- per-read path ----
    #
    # Chains as objects, then one extension generator a read driven in
    # rounds: the bwa-semantics reference that the flat engine below (the
    # production route) is held to.  Never a fallback of regions_batch.

    def chain_batch(self, seed_rows: np.ndarray, l_rep: np.ndarray,
                    lens) -> list:
        """Chain + filter a batch's seed rows (``seed_batch``'s) in the
        native library; returns list[list[Chain]], one list a read."""
        B = len(lens)
        with self.timers.phase("CHAIN"):
            # seed rows are in (read, slot) order: per-read segments
            bounds = np.searchsorted(seed_rows[:, 0], np.arange(B + 1))
            skip = (np.asarray(lens) < self.opt.min_seed_len
                    ).astype(np.uint8)
            cb = chain_filter_batch_native(
                self.opt, self.idx.l_pac, self.contig_offsets, seed_rows,
                bounds, skip)
            return cb.to_lists(B, l_rep, lens)

    def extend_batch_rounds(self, codes: np.ndarray, lens,
                            chains_per_read: list) -> list:
        """Extend each read's chains (``align.region.extend_read``) in
        lockstep rounds on the Aligner's devices, with its layout's
        extension kernel and the query window of the batch's bucket;
        returns list[list[AlnReg]].  On a mesh each round's lanes are
        split into contiguous parts, one a device."""
        opt = self.opt
        kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                  e_ins=opt.e_ins, zdrop=opt.zdrop, mat_max=opt.a)
        names = ("q_l", "qlen_l", "t_l", "tlen_l", "q_r", "qlen_r", "t_r",
                 "tlen_r")

        def extend_round(lanes: dict) -> np.ndarray:
            parts = []
            for d, (lo, hi) in enumerate(self.mesh.split(len(lanes["h0"]))):
                if hi > lo:
                    dev = self.mesh[d]
                    a = {k: self._put(v[lo:hi], dev)
                         for k, v in lanes.items()}
                    out = extend_seed_batch(
                        *(a[k] for k in names), self.mat_on(dev), a["w0"],
                        a["h0"], a["pen5"], a["pen3"], core=self.ext_core,
                        **kw)
                    parts.append(torch.stack(
                        [*out.left, *out.right, out.aw0, out.aw1]
                    ).to(self.device))
            return torch.cat(parts, dim=1).cpu().numpy()

        with self.timers.phase("BSW"):
            gens = [extend_read(opt, self.idx.l_pac, self.idx.fetch_ref,
                                int(lens[b]), codes[b, : lens[b]],
                                chains_per_read[b])
                    for b in range(len(chains_per_read))]
            return run_extension_rounds(
                gens, opt, extend_round,
                q_pad=batch_widths(opt, np.shape(codes)[1]).ext_q)

    # ------------------------------------------ flat extension path ----

    def _regions_flat(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch via the flat native engine;
        returns (fields, bounds) as ``flatext.finalize_fields`` gives
        them."""
        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        seed_rows_h, l_rep = self.seed_batch_finish(seed_handle)

        B = batch.n
        with self.timers.phase("CHAIN"):
            bounds = np.searchsorted(seed_rows_h[:, 0], np.arange(B + 1))
            skip = (np.asarray(batch.lens) < self.opt.min_seed_len
                    ).astype(np.uint8)
            handle, jobs, n_jobs = flatext.prepare_jobs(
                self.opt, self.idx.l_pac, self.contig_offsets, seed_rows_h,
                bounds, skip, batch.lens, l_rep[:B])
        with self.timers.phase("BSW"):
            results = flatext.run_phased(
                self, seed_handle.codes_dev, seed_handle.lens_dev, handle,
                jobs, n_jobs, lens_host=batch.lens,
                codes_on=seed_handle.codes_on)
            return flatext.finalize_fields(handle, results, B, n_jobs)

    def regions_batch(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch; returns list[list[AlnReg]]."""
        fields, fbounds = self._regions_flat(batch, seed_handle=seed_handle)
        with self.timers.phase("REGS"):
            return [read_regions(fields, fbounds, b)
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
                                         fbounds,
                                         codes_dev=seed_handle.codes_dev)

    def _se_records_from_regs(self, batch, read_id0: int, regs):
        """SAM records of every read from its regions: the generator tier
        (``finalize.se_records_g``), all reads in lockstep rounds whose
        CIGAR fills run as device batches (``self.ga_exec``)."""
        with self.timers.phase("SAM"):
            gens = [
                finalize.se_records_g(
                    self.opt, self.idx, batch.names[b], batch.seqs[b],
                    batch.quals[b], batch.codes[b, : batch.lens[b]],
                    regs[b], read_id0 + b)
                for b in range(batch.n)
            ]
            return drive_rounds(gens, self.ga_exec)

    def align_se_batch(self, batch, read_id0: int, seed_handle=None):
        """Align a ReadBatch single-end; returns list[list[SamRecord]]
        (their lines are ``align_se_text``'s)."""
        regs = self.regions_batch(batch, seed_handle=seed_handle)
        return self._se_records_from_regs(batch, read_id0, regs)


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

    `device` is one device or a device list (a sequence, or a
    comma-separated string); a preset with a mesh (v5e-4, v5e-16) takes
    its mesh size from the preset, and a list must match it.
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
    devs = aligner.mesh.devices
    where = (f"device {devs[0]}" if len(devs) == 1 else
             f"mesh of {len(devs)}: {', '.join(map(str, devs))}"
             + (", SA sharded" if opt.shard_sa else ""))
    print(f"[tpu-bwa-torch] {where} (batch {opt.batch_reads}, extension "
          f"layout {ext_layout})", file=sys.stderr)
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
                     shard: tuple[int, int] | None = None,
                     timers: PhaseTimers | None = None) -> int:
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
    order reproduces the single-host output exactly.

    ``timers`` (an Aligner's) times the reader's pulls as ``FASTQ`` and
    the writes of chunk files, progress lines and the output as
    ``WRITE``."""
    import heapq
    import os
    import queue

    if timers is None:
        timers = PhaseTimers()

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
            it = enumerate(items)
            while True:
                with timers.phase("FASTQ"):
                    nxt = next(it, None)
                if nxt is None:
                    break
                gseq, (payload, n_units) = nxt
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
                        with timers.phase("WRITE"):
                            tmp = chunk_path(gseq) + ".tmp"
                            with open(tmp, "w") as f:
                                f.write(text)
                            os.replace(tmp, chunk_path(gseq))  # atomic publish
            except BaseException as e:
                err.append(e)
                stop.set()
                out_q.put(None)
                return
            with timers.phase("WRITE"), done_lock:
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
                with timers.phase("WRITE"):
                    out.write(text)
                want += 1
        while heap:  # error path: drain what completed
            _, text = heapq.heappop(heap)
            with timers.phase("WRITE"):
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
                       shard: tuple[int, int] | None = None,
                       timers: PhaseTimers | None = None) -> int:
    """The single-thread dispatch-ahead driver of SE and PE: item N+1's
    device seeding (``dispatch(payload) -> handle``) is issued before item
    N is finished (``work(payload, handle) -> text``, written to `out`).
    ``items`` yields (payload, n_units); returns the units done.

    ``chunk_dir``, ``manifest`` and ``shard`` behave as in
    ``run_ordered_pool``: an item whose chunk file exists is neither
    dispatched nor aligned (its chunk is written out as it is), and only
    this host's items (global number % n_hosts == host_id) are taken.
    ``timers`` (an Aligner's) times each pull of an item as ``FASTQ`` and
    each write of a chunk file, the output and the progress line as
    ``WRITE``.

    If the reader raises, the pending item is finished and written
    first, then the error propagates."""
    import os

    if timers is None:
        timers = PhaseTimers()

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
        with timers.phase("WRITE"):
            if chunk_dir and handle is not None:
                tmp = chunk_path(gseq) + ".tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, chunk_path(gseq))  # atomic publish
            out.write(text)
            n_done += n_units
            print(f"[tpu-bwa-torch] {n_done} reads processed",
                  file=sys.stderr)

    pend = None  # (gseq, payload, n_units, handle | None)
    it = enumerate(items)
    while True:
        try:
            with timers.phase("FASTQ"):
                nxt = next(it, None)
        except Exception:
            if pend is not None:
                finish(*pend)
            raise
        if nxt is None:
            break
        gseq, (payload, n_units) = nxt
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


def count_wide(aligner: Aligner, batch) -> None:
    """Count `batch` in ``fastq.wide_batches`` where it runs in the wide
    bucket."""
    if batch_widths(aligner.opt, batch.codes.shape[1]) is WIDE:
        count(aligner.timers, "fastq.wide_batches")


def run_se_pipeline(aligner: Aligner, fq1: str, out, workers: int = 1,
                    chunk_dir: str | None = None,
                    manifest: dict | None = None,
                    shard: tuple[int, int] | None = None) -> int:
    """SE driver.  ``workers == 1`` runs ``run_dispatch_ahead``: batch
    N+1's seeding is issued before batch N is finished (seeding reads its
    round-2 candidate count on the host, so rounds 1 and 2 complete
    before it returns; only round 3 and the seed rows overlap batch N).
    ``workers > 1`` runs the ordered thread pool, each worker aligning
    whole batches.  A batch holding a read of 161-256 bp is read in the
    wide bucket (``fastq.wide_batches``).  Returns the reads done."""
    opt = aligner.opt

    def items():
        read_id0 = 0
        for batch in stream_batches(fq1, opt.batch_reads, opt.max_read_len,
                                    timers=aligner.timers):
            count_wide(aligner, batch)
            yield (batch, read_id0), batch.n
            read_id0 += batch.n

    def dispatch(payload):
        return aligner.seed_batch_dispatch(payload[0].codes, payload[0].lens)

    def work(payload, handle=None) -> str:
        batch, read_id0 = payload
        return aligner.align_se_text(batch, read_id0, seed_handle=handle)

    kw = dict(chunk_dir=chunk_dir, manifest=manifest, shard=shard,
              timers=aligner.timers)
    if workers <= 1:
        return run_dispatch_ahead(items(), dispatch, work, out, **kw)
    return run_ordered_pool(items(), work, out, workers, **kw)
