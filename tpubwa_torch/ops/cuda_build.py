"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  ``build`` compiles it
with nvcc for sm_90a into ``build/tpubwa_torch/`` at first use, keyed by a
hash of the source, and loads it with ctypes; each kernel gets its own
``.so`` and sets its own argtypes; ``csrc/*.cuh`` holds what sources
share, and the key covers it.  There is no fallback: a missing nvcc or a
failed build raises.

``-t N`` worker threads share the wrappers, so the first build of a
kernel and the wrappers' ``launches`` counters are guarded.  Each source
has its own lock (``lock(name)``), held around the check-build-load here
and around each wrapper's ``build()``, so two sources still build in
parallel; ``count_launch`` adds to a counter under a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpubwa_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks: dict[str, threading.RLock] = {}
_locks_lock = threading.Lock()
_count_lock = threading.Lock()


def lock(name: str) -> threading.RLock:
    """The lock of kernel source `name` (re-entrant: a wrapper's build()
    holds it while it calls ``build``)."""
    with _locks_lock:
        return _locks.setdefault(name, threading.RLock())


def count_launch(fn) -> None:
    """One more launch on wrapper `fn`'s ``launches`` counter."""
    with _count_lock:
        fn.launches += 1


def _nvcc(src: Path) -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       f"the kernel must be built from {src}")


def build(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source (and
    of the headers beside it) exists, and load it.  Returns (library,
    nvcc's register/shared-memory report; "" when the build already
    existed)."""
    with lock(name):
        src = CSRC / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):   # what a source includes
            h.update(header.read_bytes())
        tag = h.hexdigest()[:16]
        so = BUILD_DIR / f"libtpubwa_{name}_{tag}.so"
        report = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique per process and thread: other processes may build the
            # same source into the same directory at the same time
            tmp = so.with_name(
                f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([_nvcc(src), *NVCC_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            report = proc.stderr
        return ctypes.CDLL(str(so)), report
