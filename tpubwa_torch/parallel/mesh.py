"""Device mesh: one process driving N torch devices (port of
``tpubwa.parallel.mesh``: ``make_mesh``, and the fused device step
``device_align_step`` with its mesh form ``sharded_align_step``).

A read batch is split into N contiguous slices, one per device; the
FM-index is copied to each distinct device, and under ``shard_sa`` the
suffix array is split over the N devices (``ops.fm.ShardedSA``).  The
host phases see whole batches.  N entries may name one card several
times: the shards then share that card and its index copy.

The rules for devices are explicit, with no fallback:

- a sequence of devices (or a comma-separated string) is the mesh as
  given, duplicates allowed;
- ``"cpu"`` with N gives N CPU shards;
- ``"cuda"`` with N gives ``cuda:0`` .. ``cuda:N-1`` and raises
  ``DevicesUnavailable`` when torch sees fewer than N cards: it never
  takes the CPU or repeats a card in their place;
- ``"cuda:k"`` (or any single indexed device) with N > 1 raises
  ``ValueError``: name the devices in a list;
- N = 1 is the one-device path (``resolve_device``).

A mesh refused for want of cards raises ``DevicesUnavailable``, which the
CLI prints as one line; one device that is not there raises a plain
``RuntimeError``.

``device_align_step`` runs SMEM seeding (K2 on a CUDA device), the seed
expansion and one banded extension a read (K1) with no host step between
them: the JAX package's "flagship compiled program" and the body of its
``__graft_entry__.entry``.  ``sharded_align_step`` splits its reads over
a mesh.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpubwa_torch.config import NARROW, MemOptions, batch_widths
from tpubwa_torch.ops.extend import extend_batch
from tpubwa_torch.ops.fm import DeviceIndex, fetch_ref_batch
from tpubwa_torch.ops.seeds import smems_to_seeds
from tpubwa_torch.ops.smem_chain import collect_smems_chain_fused


class DevicesUnavailable(RuntimeError):
    """A CUDA device the caller asked for is not visible to torch."""


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of torch devices; shard d runs on ``devices[d]``."""

    devices: tuple

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, d: int) -> torch.device:
        return self.devices[d]

    @property
    def distinct(self) -> tuple:
        """The devices of the mesh, each once, in first-use order."""
        return tuple(dict.fromkeys(self.devices))

    def split(self, n: int) -> list[tuple[int, int]]:
        """(lo, hi) of each shard's contiguous slice of n items: slices of
        ceil(n / N); the last ones may be shorter or empty."""
        per = math.ceil(n / len(self.devices)) if n else 0
        return [(min(d * per, n), min((d + 1) * per, n))
                for d in range(len(self.devices))]


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must be visible (there is
    no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           "CUDA device")
    return dev


def _visible(dev: torch.device) -> torch.device:
    """`dev`, a device of a mesh; raises DevicesUnavailable for a card
    torch does not see."""
    if dev.type == "cuda" and (dev.index or 0) >= _cuda_count():
        raise DevicesUnavailable(
            f"device {str(dev)!r} requested but torch sees "
            + (f"{_cuda_count()} CUDA device(s)" if _cuda_count()
               else "no CUDA device"))
    return dev


def _as_list(device) -> list | None:
    """The devices of a sequence or a comma-separated string, else None."""
    if isinstance(device, str):
        return device.split(",") if "," in device else None
    if isinstance(device, torch.device):
        return None
    return list(device)


def make_mesh(n: int | None, device) -> DeviceMesh:
    """The mesh of `n` devices (None: as many as `device` names) on
    `device`, by the rules of this module's note."""
    listed = _as_list(device)
    if listed is not None:
        devs = tuple(_visible(torch.device(d)) for d in listed)
        if not devs:
            raise ValueError("an empty device list")
        if n is not None and n != len(devs):
            raise ValueError(f"the device list names {len(devs)} device(s) "
                             f"but the mesh has {n}")
        return DeviceMesh(devs)
    dev = torch.device(device)
    n = 1 if n is None else int(n)
    if n < 1:
        raise ValueError(f"a mesh of {n} devices")
    if n == 1:
        return DeviceMesh((resolve_device(device),))
    if dev.type == "cpu":
        return DeviceMesh((dev,) * n)
    if dev.index is not None:
        raise ValueError(f"a mesh of {n} on the one device {str(dev)!r}: "
                         "name the devices in a list (for example "
                         f"{','.join([str(dev)] * n)})")
    if dev.type == "cuda":
        count = _cuda_count()
        if count < n:
            raise DevicesUnavailable(
                f"a mesh of {n} CUDA devices, but torch sees "
                + ("no CUDA device" if count == 0 else f"{count}")
                + "; name the devices in a list to share cards")
        return DeviceMesh(tuple(torch.device("cuda", d) for d in range(n)))
    raise ValueError(f"no mesh of {n} for device type {dev.type!r}")


# device_align_step's extension: the JAX step's fixed gap penalties
STEP_EXT = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100, mat_max=1)


def step_windows(di: DeviceIndex, codes: torch.Tensor, lens: torch.Tensor,
                 sb, mat) -> tuple:
    """``extend_batch``'s arguments in ``device_align_step`` (with
    ``STEP_EXT``): from the end of each read's longest seed of `sb` (the
    first of equal maxima, as ``jnp.argmax`` and ``torch.argmax`` take
    it), the query suffix [B, L] against the L + 64 reference bases after
    the seed; band 100, h0 the seed's length, end bonus 5.  A read
    without a seed gets qlen and tlen 0."""
    B, L = codes.shape
    dev = codes.device
    slen = torch.where(sb.valid, sb.len, 0)
    best = torch.argmax(slen, dim=1, keepdim=True)
    s_rbeg = sb.rbeg.gather(1, best)[:, 0]
    s_qbeg = sb.qbeg.gather(1, best)[:, 0]
    s_len = slen.gather(1, best)[:, 0]
    has_seed = s_len > 0

    qe = s_qbeg + s_len
    jb = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    q_right = codes.gather(1, (qe[:, None] + jb).clamp(0, L - 1).long())
    qlen_r = torch.where(has_seed, lens - qe, 0)

    t_pos = (s_rbeg + s_len)[:, None] + torch.arange(
        L + 64, dtype=torch.int32, device=dev)[None, :]
    t_right = fetch_ref_batch(di, t_pos)
    tlen_r = torch.where(has_seed, torch.clamp(
        2 * di.l_pac - (s_rbeg + s_len), max=L + 64), 0).to(torch.int32)

    def full(v):
        return torch.full((B,), v, dtype=torch.int32, device=dev)

    return (q_right, qlen_r, t_right, tlen_r,
            torch.as_tensor(mat, device=dev), full(100),
            torch.clamp(s_len, min=1), full(5))


def device_align_step(di: DeviceIndex, codes: torch.Tensor,
                      lens: torch.Tensor, mat, *, min_seed_len: int = 19,
                      max_occ: int = 500) -> tuple:
    """One device step on reads on the device of `di`: SMEM seeding (K2
    on a CUDA device) -> seed expansion (64 slots a read) -> one right
    extension a read from the end of its longest seed (K1;
    ``step_windows``).

    Returns (rbeg, qbeg, len, valid) of the [B, 64] seed slots and the
    extension score [B].  Takes the narrow bucket's reads only (its 64
    slots are sized for them): a wider batch raises."""
    if batch_widths(MemOptions(), codes.shape[1]) is not NARROW:
        raise ValueError(
            f"device_align_step takes reads of at most "
            f"{MemOptions.max_read_len} bp (a batch {codes.shape[1]} wide): "
            "align a wide batch with Aligner")
    codes = codes.to(torch.int32)
    lens = lens.to(torch.int32)
    sm = collect_smems_chain_fused(di, codes, lens,
                                   min_seed_len=min_seed_len)
    sb = smems_to_seeds(di, sm, max_occ=max_occ, out_seeds=64)
    ext = extend_batch(*step_windows(di, codes, lens, sb, mat), **STEP_EXT)
    return sb.rbeg, sb.qbeg, sb.len, sb.valid, ext.score


def sharded_align_step(mesh: DeviceMesh, di: DeviceIndex, codes: np.ndarray,
                       lens: np.ndarray, mat) -> tuple:
    """``device_align_step`` with the reads split into the mesh's
    contiguous slices, one a device, and one copy of the index a distinct
    device; the results are joined in shard order on the mesh's first
    device."""
    copies = {dev: DeviceIndex(*(f.to(dev) if torch.is_tensor(f) else f
                                 for f in di))
              for dev in mesh.distinct}
    codes = np.asarray(codes, np.int32)
    lens = np.asarray(lens, np.int32)
    parts = []
    for d, (lo, hi) in enumerate(mesh.split(len(codes))):
        if hi > lo:
            dev = mesh[d]
            parts.append(device_align_step(
                copies[dev], torch.as_tensor(codes[lo:hi], device=dev),
                torch.as_tensor(lens[lo:hi], device=dev), mat))
    return tuple(torch.cat([p[f].to(mesh[0]) for p in parts])
                 for f in range(5))
