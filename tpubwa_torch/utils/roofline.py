"""The card's peaks and the operation counts that kernel bounds are made of.

One place for ``chip_smoke.py`` and ``tools.bench --kernel``, so the two
never disagree.  A kernel's bound is the larger of (bytes it must move) /
``HBM_BPS`` and (integer operations on the run's data) / ``INT32_OPS``.
The ``OPS_*`` constants are what the function needs for one band cell,
traceback step, extension step or LF step, not what a kernel happens to
execute.
"""

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s
# of HBM; 67 TFLOP/s of float32 outside the tensor cores is 128 lanes per
# SM at 2 FLOPs per fused multiply-add, and int32 has 64 lanes per SM at
# one operation each, so 67e12 / 2 / 2 integer operations a second.
HBM_BPS = 3.35e12
INT32_OPS = 67e12 / 2 / 2
# integer operations per unit of work, counted from the kernels' sources
OPS_EXT_CELL = 15      # K1 / K1b: one band cell of ksw_extend2
OPS_SW_CELL = 12       # K4: one cell of the local SW
OPS_GA_CELL = 25       # K3: one band cell of the global fill (+ direction)
OPS_GA_STEP = 12       # K3: one traceback step with its RLE
# K2: one extension step, by the least arithmetic that computes it (not the
# kernel's own, which counts each base separately).  occ of the four bases
# at one position, 75: the sentinel shift 2, block and offset 2, the row's
# address 1; per packed word 13 (the two bit planes 3, the position mask 4,
# the masked planes 2, their and 1, three popcounts: both planes and the
# and); the three sums over the four words 9; the four bases' counts from
# the sums and the offset 5 (the fourth base follows from the other
# three); adding the checkpoint counts 4: 5 + 4 * 13 + 9 + 5 + 4.  The
# update, 30: four interval sizes 4, the sentinel test 4, the chain of
# co-interval starts 4, the L2 add 1, three selects by base 9, the swaps
# of a forward step 4, the take rule 3, the advance 1.
OPS_OCC4 = 5 + 4 * 13 + 9 + 5 + 4
OPS_CHAIN_STEP = 2 * OPS_OCC4 + 30
OPS_LF_STEP = 60       # K5: one probe + one LF step (one base's occ)
