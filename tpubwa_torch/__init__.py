"""tpubwa_torch — the PyTorch/CUDA port of the tpubwa short-read aligner.

A second package beside ``tpubwa`` (the JAX reference).  It imports
``torch`` and never ``jax`` nor anything of ``tpubwa``: it keeps its own
copies of the host code (FASTA/FASTQ/SAM I/O, the FM-index builder with the
same on-disk format, ``MemOptions``, the native C++ host library), and
everything that ran on the TPU runs here on an explicit torch ``device``.

Layout mirrors ``tpubwa``:
  tpubwa_torch.ops    — device compute: FM search, SMEM chains, seed rows,
                        extension DP, global DP, mate rescue, sampled SA;
                        each loop of dependent steps is a hand-written
                        CUDA kernel with its plain version beside it
  tpubwa_torch.align  — flat extension driver, flat SAM, pairing, the Aligner
  tpubwa_torch.parallel — the device mesh: a batch split over N devices
  tpubwa_torch.csrc   — CUDA C++ kernel sources, built by nvcc at first use
  tpubwa_torch.native — C++ host library sources, built by g++ at first use
  tpubwa_torch.index / io / utils / config — host code
  tpubwa_torch.cli    — ``tpu-bwa-torch index|mem``

Ported: single-end and paired-end alignment, the serving modes (wide
index, sampled SA, ``--chunks``, ``--hosts``, ``-t N``), the device mesh
(reads split over N devices, the suffix array copied or sharded), the
big-genome build and serve (``tools.big``), the per-read chain-and-extend
path (``Aligner.chain_batch`` + ``extend_batch_rounds``), the fused
device step (``parallel.mesh.device_align_step``, ``sharded_align_step``)
and the scalar oracles (``ops.extend_ref``, ``ops.fm_ref``, the NumPy
suffix array): all of ``tpubwa`` but its TPU workarounds.
"""

__version__ = "0.1.0"
