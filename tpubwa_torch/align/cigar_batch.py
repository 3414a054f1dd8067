"""Batched CIGAR generation executor (port of ``tpubwa.align.cigar_batch``).

Executes the global-alignment jobs yielded by the finalize generators
(finalize.gen_cigar_g) as one device batch per (Q, T) size bucket per
round, with the traceback on the device as well (one kernel launch per
bucket on a CUDA device).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpubwa_torch.config import MemOptions
from tpubwa_torch.ops.global_align import global_align, steps_to_cigar
from tpubwa_torch.ops.global_align_cuda import global_align_cigar_core


@dataclasses.dataclass
class GAJob:
    """One global-alignment request: full query vs full target, band w."""

    query: np.ndarray   # int codes, forward orientation of the DP
    target: np.ndarray
    w: int


# (Q_pad, T_pad) buckets, smallest fitting bucket wins; jobs beyond the
# largest bucket run the scalar host DP (only patch jobs spanning unusually
# long windows)
BUCKETS = ((64, 128), (192, 256), (192, 512), (320, 1024))


class GABatchExecutor:
    """execute(jobs: list[GAJob]) -> list[(score, cigar)] via device
    batches; ``put`` moves a host array to the aligner's device."""

    def __init__(self, opt: MemOptions, put):
        self.opt = opt
        self.mat = opt.score_matrix()
        self._put = put
        self._mat_dev = put(self.mat)

    def __call__(self, jobs: list[GAJob]) -> list:
        opt = self.opt
        out: list = [None] * len(jobs)
        by_bucket: dict[tuple[int, int], list[int]] = {}
        for i, job in enumerate(jobs):
            ql, tl = len(job.query), len(job.target)
            for bq, bt in BUCKETS:
                if ql <= bq and tl <= bt:
                    by_bucket.setdefault((bq, bt), []).append(i)
                    break
            else:  # oversized jobs: scalar host DP
                out[i] = global_align(
                    np.asarray(job.query), np.asarray(job.target), self.mat,
                    opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, job.w)

        for (bq, bt), idxs in by_bucket.items():
            B = len(idxs)
            q = np.zeros((B, bq), np.int32)
            t = np.zeros((B, bt), np.int32)
            qlen = np.zeros(B, np.int32)
            tlen = np.zeros(B, np.int32)
            w = np.zeros(B, np.int32)
            for r, i in enumerate(idxs):
                job = jobs[i]
                ql, tl = len(job.query), len(job.target)
                q[r, :ql] = job.query
                t[r, :tl] = job.target
                qlen[r] = ql
                tlen[r] = tl
                w[r] = job.w
            put = self._put
            res = global_align_cigar_core(
                put(q), put(qlen), put(t), put(tlen), self._mat_dev, put(w),
                o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins)
            score = res.score.cpu().numpy()
            steps = res.steps.cpu().numpy()
            for r, i in enumerate(idxs):
                out[i] = (int(score[r]), steps_to_cigar(steps[r]))
        return out


class GAScalarExecutor:
    """Same interface, host numpy DP — the correctness reference."""

    def __init__(self, opt: MemOptions):
        self.opt = opt
        self.mat = opt.score_matrix()

    def __call__(self, jobs: list[GAJob]) -> list:
        opt = self.opt
        return [
            global_align(np.asarray(j.query), np.asarray(j.target),
                         self.mat, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, j.w)
            for j in jobs
        ]
