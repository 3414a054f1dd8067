"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  ``build`` compiles it
with nvcc for sm_90a into ``build/tpubwa_torch/`` at first use, keyed by a
hash of the source, and loads it with ctypes; each kernel gets its own
``.so`` and sets its own argtypes.  There is no fallback: a missing nvcc
or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpubwa_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc(src: Path) -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       f"the kernel must be built from {src}")


def build(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source
    exists, and load it.  Returns (library, nvcc's register/shared-memory
    report; "" when the build already existed)."""
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libtpubwa_{name}_{tag}.so"
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(src), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so)
        report = proc.stderr
    return ctypes.CDLL(str(so)), report
