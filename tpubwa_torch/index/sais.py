"""Suffix array construction.

The C++ SA-IS library (native/sais.cpp), compiled at first use with g++ and
loaded via ctypes; a failed build raises.

It builds the suffix array of ``codes + sentinel`` where the sentinel is
strictly smaller than every code — i.e. the returned SA has length n+1 and
SA[0] == n.
"""
from __future__ import annotations

import ctypes

import numpy as np

from tpubwa_torch.native.build import load_native as _load_native


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes (values 0..3) + virtual sentinel.

    Returns int64 array of length n+1 with sa[0] == n.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
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
