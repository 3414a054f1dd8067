"""DNA sequence encoding utilities.

Encoding follows bwa's ``nst_nt4_table``: A=0, C=1, G=2, T=3, anything else=4
(ambiguous).  2-bit packing (16 bases / uint32 word) matches the HBM layout of
the FM-index occ checkpoints (reference design: GET_OCC cache-line blocks,
SURVEY.md §7 "FM-index memory behavior").
"""
from __future__ import annotations

import numpy as np

# ASCII -> 0..4 lookup (case-insensitive).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i

CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode()
    return NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space; N (4) stays 4."""
    c = codes[::-1]
    return np.where(c < 4, 3 - c, c).astype(codes.dtype)


def revcomp_str(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes into uint32 words, 16 codes per word, little-endian
    within the word (code i occupies bits [2i, 2i+2) of word i//16).

    Input length is padded to a multiple of 16 with code 0; callers are
    responsible for prefix-masking at the tail.
    """
    codes = np.asarray(codes, dtype=np.uint32)
    if codes.size % 16:
        codes = np.concatenate(
            [codes, np.zeros(16 - codes.size % 16, dtype=np.uint32)]
        )
    codes = codes.reshape(-1, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(codes << shifts, axis=1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit; returns first n codes as uint8."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    codes = ((words[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
    return codes[:n]
