"""Device mesh: one process driving N torch devices (port of
``tpubwa.parallel.mesh.make_mesh``).

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
"""
from __future__ import annotations

import dataclasses
import math

import torch


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

