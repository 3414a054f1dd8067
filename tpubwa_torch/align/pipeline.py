"""End-to-end alignment pipeline on a torch device (port of
``tpubwa.align.pipeline``): FASTQ -> device seeding -> native chaining ->
device extension waves -> native finalize -> flat SAM; paired ends add
pairing and mate rescue (``align/pair.py``).

Phase timers keep the reference's names (SMEM / SAL / CHAIN / BSW / SAM).
Everything on the device runs on the Aligner's explicit ``device``; the
native host library ``libtpubwa.so`` is required.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import tpubwa_torch
from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex
from tpubwa.io.fastq import stream_batches
from tpubwa.io.sam import sam_header
from tpubwa.utils.timers import PhaseTimers
from tpubwa_torch.align import flatext, flatsam
from tpubwa_torch.align.cigar_batch import GABatchExecutor
from tpubwa_torch.ops.extend_cuda import extend_core, extend_core_b
from tpubwa_torch.ops.fm import DeviceIndex
from tpubwa_torch.ops.seeds import seed_rows
from tpubwa_torch.ops.smem_chain import collect_smems_chain


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


# the extension kernel per layout: "t" is K1 (a thread per job), "b" is
# K1b (a warp per job); both compute the same function
EXT_CORES = {"t": extend_core, "b": extend_core_b}


class Aligner:
    """Holds the loaded index (host + device) and aligns read batches on
    one torch device.  ``ext_layout`` picks the extension kernel
    (``EXT_CORES``); the output does not depend on it."""

    def __init__(self, idx: FMIndex, opt: MemOptions | None = None, *,
                 device, ext_layout: str = "t"):
        if ext_layout not in EXT_CORES:
            raise ValueError(f"ext_layout {ext_layout!r}: choose from "
                             f"{sorted(EXT_CORES)}")
        self.idx = idx
        self.opt = opt or MemOptions()
        if self.opt.mesh_shape:
            raise _not_ported("a device mesh (mesh_shape)", "P9")
        if self.opt.shard_sa:
            raise _not_ported("the sharded suffix array (shard_sa)", "P9")
        if self.opt.sa_sample_shift:
            raise _not_ported("the sampled suffix array (sa_sample_shift)",
                              "P8")
        if idx.seq_len + 1 >= 1 << 31:
            raise _not_ported("a wide (>= 2^31) index", "P8")
        self.device = resolve_device(device)
        flatext.native_lib()          # fail now, not mid-batch
        self.mat = self.opt.score_matrix()
        self.contig_offsets = np.array([c.offset for c in idx.contigs],
                                       dtype=np.int64)
        self.di = DeviceIndex.from_host(idx, self.device)
        self.ext_core = EXT_CORES[ext_layout]
        self.n_overflow = 0  # reads whose SMEM/seed buffers overflowed
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
                           per_read_cap=opt.max_seeds_per_read)
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
                self.n_overflow += n_ovf
                print(f"[tpu-bwa-torch] warning: {n_ovf} read(s) exceeded "
                      "SMEM/seed buffer caps; their seed lists were "
                      "truncated", file=sys.stderr)
            rows = cs.packed[:n].cpu().numpy()
        return rows, l_rep

    # ------------------------------------------ flat extension path ----

    def _regions_flat(self, batch, seed_handle=None):
        """Seed + chain + extend a ReadBatch via the flat native engine;
        returns (fields, bounds) as ``tpubwa.align.flatext.finalize_fields``
        gives them."""
        from tpubwa.align.flatext import finalize_fields, prepare_jobs

        if seed_handle is None:
            seed_handle = self.seed_batch_dispatch(batch.codes, batch.lens)
        seed_rows_h, l_rep = self.seed_batch_finish(seed_handle)
        codes_dev, lens_dev = seed_handle[2], seed_handle[3]

        B = batch.n
        with self.timers.phase("CHAIN"):
            bounds = np.searchsorted(seed_rows_h[:, 0], np.arange(B + 1))
            skip = (np.asarray(batch.lens) < self.opt.min_seed_len
                    ).astype(np.uint8)
            prep = prepare_jobs(
                self.opt, self.idx.l_pac, self.contig_offsets, seed_rows_h,
                bounds, skip, batch.lens, l_rep[:B])
        if prep is None:
            raise RuntimeError("libtpubwa.so (tpubwa/native) failed to "
                               "build or load")
        handle, jobs, n_jobs = prep
        with self.timers.phase("BSW"):
            results = flatext.run_phased(self, codes_dev, lens_dev, handle,
                                         jobs, n_jobs, lens_host=batch.lens)
            return finalize_fields(handle, results, B, n_jobs)

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
    index is missing or paired FASTQs differ in read count."""
    if chunk_dir is not None or shard is not None:
        raise _not_ported("--chunks resume and --hosts sharding", "P8")
    if threads > 1:
        raise _not_ported("the -t worker pool", "P8")
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
    if fq2 is not None:
        from tpubwa_torch.align.pair import align_pe_fastq

        return align_pe_fastq(aligner, fq1, fq2, out)
    run_se_pipeline(aligner, fq1, out)
    print(aligner.timers.report(), file=sys.stderr)
    return 0


def run_dispatch_ahead(items, dispatch, finish) -> None:
    """The single-thread dispatch-ahead driver of SE and PE: item N+1's
    device seeding (``dispatch(item) -> handle``) is issued before item N
    is finished (``finish(item, handle)`` aligns it and writes its text).

    If the reader raises, the pending item is finished and written
    first, then the error propagates."""
    pend = None  # (item, handle)
    it = iter(items)
    while True:
        try:
            item = next(it)
        except StopIteration:
            break
        except Exception:
            if pend is not None:
                finish(*pend)
            raise
        handle = dispatch(item)
        if pend is not None:
            finish(*pend)
        pend = (item, handle)
    if pend is not None:
        finish(*pend)


def run_se_pipeline(aligner: Aligner, fq1: str, out) -> int:
    """SE driver in the JAX package's dispatch-ahead order: batch N+1's
    seeding is issued before batch N is finished.  The chain loops check
    for DONE lanes on the host, so seeding here completes before it
    returns and the two do not overlap yet.  Returns the reads done."""
    opt = aligner.opt
    n_done = 0

    def items():
        read_id0 = 0
        for batch in stream_batches(fq1, opt.batch_reads, opt.max_read_len):
            yield batch, read_id0
            read_id0 += batch.n

    def dispatch(item):
        return aligner.seed_batch_dispatch(item[0].codes, item[0].lens)

    def finish(item, handle) -> None:
        nonlocal n_done
        batch, read_id0 = item
        out.write(aligner.align_se_text(batch, read_id0, seed_handle=handle))
        n_done += batch.n
        print(f"[tpu-bwa-torch] {read_id0 + batch.n} reads processed",
              file=sys.stderr)

    run_dispatch_ahead(items(), dispatch, finish)
    return n_done
