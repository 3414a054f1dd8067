"""Flat whole-seed extension: job descriptors in, DP results out, with the
query/target windows gathered on the device (port of
``tpubwa.ops.extend_flat``).

The native host engine (``native/extension.cpp`` ext_prepare) emits one
descriptor per chain seed — (read_id, qbeg, slen, rbeg, rmax0, rmax1,
h0) — and these functions build the (query, target) buffers with gathers
from the device-resident read batch and 2-bit packed reference, then run
the left and right extensions with bwa's band-doubling retry.
"""
from __future__ import annotations

import torch

from tpubwa_torch.config import NARROW
from tpubwa_torch.ops.extend import _extend_core, _with_retry
from tpubwa_torch.ops.fm import (DeviceIndex, ref_window_left,
                                 ref_window_right)

I32 = torch.int32

# (query, target) pad widths of the extension windows: the truncation they
# impose is part of the output (the JAX package's round driver uses them).
# Q_PAD is the narrow bucket's; a wide batch's callers pass its q_pad
# (config.WIDE.ext_q)
Q_PAD = NARROW.ext_q
T_PAD = 768


def extend_jobs_left(di: DeviceIndex, codes: torch.Tensor,
                     lens: torch.Tensor, rd: torch.Tensor,
                     qbeg: torch.Tensor, rbeg: torch.Tensor,
                     rmax0: torch.Tensor, h0: torch.Tensor, mat, *,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, mat_max: int, w0: int, pen_clip5: int,
                     q_pad: int = Q_PAD, t_pad: int = T_PAD,
                     core=None) -> torch.Tensor:
    """LEFT extension of J seed jobs: query[0:qbeg] reversed against
    ref[rmax0:rbeg] reversed.  Returns int32 [8, J] = (score, qle, tle,
    gtle, gscore, max_off, aw0, score0)."""
    core = core or _extend_core
    dev = codes.device
    L = codes.shape[1]
    J = rd.shape[0]
    qg = codes.to(I32)[rd]
    jq = torch.arange(q_pad, dtype=I32, device=dev)[None, :]
    jt = torch.arange(t_pad, dtype=I32, device=dev)[None, :]
    qlen_l = torch.clamp(qbeg, max=q_pad).to(I32)
    qidx = (qbeg[:, None] - 1 - jq).clamp(0, L - 1).to(torch.int64)
    q_l = torch.where(jq < qlen_l[:, None], qg.gather(1, qidx), 4)
    # window lengths fit int32 regardless of the (int64) rbeg
    tlen_l = torch.clamp(rbeg - rmax0, max=t_pad).to(I32)
    t_l = torch.where(jt < tlen_l[:, None],
                      ref_window_left(di, rbeg, t_pad), 4)

    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    h0v = torch.clamp(h0, min=1).to(I32)
    w0v = torch.full((J,), w0, dtype=I32, device=dev)
    pen5 = torch.full((J,), pen_clip5, dtype=I32, device=dev)
    left, aw0 = _with_retry(core, q_l, qlen_l, t_l, tlen_l.clamp(min=0),
                            mat, w0v, h0v, pen5, -1, kw)
    score0 = torch.where(qlen_l > 0, left.score, h0v)
    return torch.stack(list(left) + [aw0, score0]).to(I32)


def extend_jobs_right(di: DeviceIndex, codes: torch.Tensor,
                      lens: torch.Tensor, rd: torch.Tensor,
                      qbeg: torch.Tensor, slen: torch.Tensor,
                      rbeg: torch.Tensor, rmax1: torch.Tensor,
                      score0: torch.Tensor, mat, *,
                      o_del: int, e_del: int, o_ins: int, e_ins: int,
                      zdrop: int, mat_max: int, w0: int, pen_clip3: int,
                      q_pad: int = Q_PAD, t_pad: int = T_PAD,
                      core=None) -> torch.Tensor:
    """RIGHT extension (seeded with the left pass's score0): query[qe:]
    against ref[rbeg+slen : rmax1].  Returns int32 [7, J] = (score, qle,
    tle, gtle, gscore, max_off, aw1)."""
    core = core or _extend_core
    dev = codes.device
    L = codes.shape[1]
    J = rd.shape[0]
    qg = codes.to(I32)[rd]
    jq = torch.arange(q_pad, dtype=I32, device=dev)[None, :]
    jt = torch.arange(t_pad, dtype=I32, device=dev)[None, :]
    qe = qbeg + slen
    qlen_r = torch.clamp(lens[rd] - qe, max=q_pad).to(I32)
    qidx = (qe[:, None] + jq).clamp(0, L - 1).to(torch.int64)
    q_r = torch.where(jq < qlen_r[:, None], qg.gather(1, qidx), 4)
    re0 = rbeg + slen
    tlen_r = torch.clamp(rmax1 - re0, max=t_pad).to(I32)
    t_r = torch.where(jt < tlen_r[:, None],
                      ref_window_right(di, re0, t_pad), 4)

    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max)
    sc0 = score0.to(I32)
    w0v = torch.full((J,), w0, dtype=I32, device=dev)
    pen3 = torch.full((J,), pen_clip3, dtype=I32, device=dev)
    right, aw1 = _with_retry(core, q_r, qlen_r.clamp(min=0), t_r,
                             tlen_r.clamp(min=0), mat, w0v, sc0, pen3, sc0,
                             kw)
    return torch.stack(list(right) + [aw1]).to(I32)


def extend_jobs(di: DeviceIndex, codes: torch.Tensor, lens: torch.Tensor,
                rd: torch.Tensor, qbeg: torch.Tensor, slen: torch.Tensor,
                rbeg: torch.Tensor, rmax0: torch.Tensor, rmax1: torch.Tensor,
                h0: torch.Tensor, mat, *, o_del: int, e_del: int, o_ins: int,
                e_ins: int, zdrop: int, mat_max: int, w0: int,
                pen_clip5: int, pen_clip3: int, q_pad: int = Q_PAD,
                t_pad: int = T_PAD, core=None) -> torch.Tensor:
    """Whole-seed extension (left, then right seeded with the left score);
    returns int32 [14, J] = left (score, qle, tle, gtle, gscore, max_off),
    right (same), aw0, aw1 — the order native ext_finalize consumes."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, mat_max=mat_max, w0=w0, q_pad=q_pad,
              t_pad=t_pad, core=core)
    left = extend_jobs_left(di, codes, lens, rd, qbeg, rbeg, rmax0, h0, mat,
                            pen_clip5=pen_clip5, **kw)
    right = extend_jobs_right(di, codes, lens, rd, qbeg, slen, rbeg, rmax1,
                              left[7], mat, pen_clip3=pen_clip3, **kw)
    return torch.cat([left[:6], right[:6], left[6:7], right[6:7]])
