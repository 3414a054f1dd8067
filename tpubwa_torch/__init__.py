"""tpubwa_torch — the PyTorch/CUDA port of the tpubwa short-read aligner.

A second package beside ``tpubwa`` (the JAX reference).  It imports
``torch`` and never ``jax``; framework-free host code (FASTA/FASTQ/SAM I/O,
the FM-index builder, ``MemOptions``, the native ``libtpubwa.so`` and
chaining) is imported from ``tpubwa``, and everything that ran on the TPU
runs here on an explicit torch ``device``.

Layout mirrors ``tpubwa``:
  tpubwa_torch.ops    — device compute: FM search, SMEM chains, seed rows,
                        extension DP (hand-written CUDA kernel), global DP
  tpubwa_torch.align  — flat extension driver, flat SAM, the Aligner
  tpubwa_torch.csrc   — CUDA C++ kernel sources, built by nvcc at first use
  tpubwa_torch.cli    — ``tpu-bwa-torch index|mem``

Ported so far: the single-end main path on an index under 2^31
characters, on one device.
"""

__version__ = "0.1.0"
