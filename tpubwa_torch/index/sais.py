"""Suffix array construction.

The C++ SA-IS library (native/sais.cpp), compiled at first use with g++ and
loaded via ctypes; a failed build raises.  ``use_native=False`` builds
with NumPy prefix doubling instead (O(n log^2 n)), a second construction
written apart from SA-IS that the tests hold it to; it is never taken
in SA-IS's place when the build fails.

Both build the suffix array of ``codes + sentinel`` where the sentinel is
strictly smaller than every code — i.e. the returned SA has length n+1 and
SA[0] == n.
"""
from __future__ import annotations

import ctypes

import numpy as np

from tpubwa_torch.native.build import load_native as _load_native


def suffix_array(codes: np.ndarray,
                 use_native: bool | None = None) -> np.ndarray:
    """Suffix array of codes (values 0..3) + virtual sentinel.

    ``use_native`` None or True: SA-IS in the native library (raises when
    it cannot be built); False: NumPy prefix doubling.
    Returns int64 array of length n+1 with sa[0] == n.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if use_native is False:
        return _suffix_array_doubling(codes)
    n = codes.size
    lib = _load_native()
    s = np.empty(n + 1, dtype=np.uint8)
    s[:n] = codes + 1
    s[n] = 0
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.sais_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n + 1, 5)
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed: {rc}")
    return sa


def _suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """NumPy prefix-doubling suffix array (with sentinel), O(n log² n)."""
    n = codes.size + 1
    rank = np.zeros(n, dtype=np.int64)
    rank[: n - 1] = codes.astype(np.int64) + 1  # sentinel gets rank 0
    k = 1
    sa = np.argsort(rank, kind="stable")
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        new_rank = np.zeros(n, dtype=np.int64)
        r1 = rank[order]
        r2 = key2[order]
        changed = np.ones(n, dtype=np.int64)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        ranks_sorted = np.cumsum(changed) - 1
        new_rank[order] = ranks_sorted
        rank = new_rank
        sa = order
        if ranks_sorted[-1] == n - 1:
            break
        k *= 2
        if k >= n:
            break
    return sa.astype(np.int64)


def bwt_and_primary(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT of codes+sentinel with the sentinel row removed.

    Returns (bwt, primary): bwt has length n (codes 0..3); ``primary`` is the
    row index whose BWT character is the sentinel (i.e. the row r with
    sa[r] == 0).  Occ queries over the full BWT adjust: occ_full(c, i) =
    occ_stored(c, i - (i > primary)).
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.size
    lib = _load_native()
    bwt = np.empty(n, dtype=np.uint8)
    primary = ctypes.c_int64()
    sa64 = np.ascontiguousarray(sa, dtype=np.int64)
    rc = lib.bwt_from_sa(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n + 1,
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(primary))
    if rc != 0:
        raise RuntimeError("bwt_from_sa failed")
    return bwt, int(primary.value)
