"""FM-index build + on-disk + HBM layout.

TPU-native redesign of bwa-mem2's index (reference: [src] FMI_search.{h,cpp}
data structures ``cp_occ``/``GET_OCC``/``sa_ms_byte``/``sa_ls_word``, cited in
PHASE4_WEEK4_POLISH.md:141-260 — see SURVEY.md §2.1/§3.2).  Differences by
design:

- occ checkpoints are a single fused int32 tensor ``cp[nblocks, 8]`` — cols
  0..3 = cumulative base counts at the block start, cols 4..7 = the block's 64
  BWT symbols 2-bit-packed into 4 words (bitcast uint32).  One HBM gather row
  fetches everything an occ query needs, mirroring GET_OCC's one-cache-line
  design (SURVEY.md §7 "FM-index memory behavior").
- the suffix array is stored full-resolution in bwa-mem2's exact 5-byte
  split layout (sa_ms_byte uint8 + sa_ls_word uint32 — [src] FMI_search.h,
  PHASE4_WEEK4_POLISH.md:148-175), so builds are valid to 2^40 bp.  HBM
  sizing at GRCh38 scale (N = 2*3.1 Gb): cp checkpoints N/64 x 32 B ~= 3.1
  GB (fits), 5-byte SA ~= 31 GB (does not fit one v5e chip) — the device
  pipeline replicates the SA only below seq_len 2^31 and the GRCh38 serving
  mode shards the SA over the mesh with all-to-all lookups (SURVEY.md §5
  "Distributed communication backend", planned).

Conventions (self-contained; property-tested against naive search):
- index text: seq = forward_ref + revcomp(forward_ref), length N = 2*l_pac.
- suffix array over seq + sentinel: rows r in [0, N], sa[0] == N.
- primary = row whose suffix starts at 0 (its BWT char is the sentinel).
- stored bwt (length N) omits the sentinel row; occ_full(c, i) =
  occ_stored(c, i - (i > primary)).
- L2[c] = 1 + #{symbols < c in seq}; empty-pattern interval = [0, N+1).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from tpubwa_torch.io.fasta import Contig, read_fasta
from tpubwa_torch.index.sais import bwt_and_primary, suffix_array
from tpubwa_torch.utils.dna import pack_2bit, unpack_2bit

CP_BLOCK = 64  # bwt symbols per occ checkpoint (ref: CP_SHIFT=6 block design)
INDEX_SUFFIX = ".tpubwa"


@dataclasses.dataclass
class FMIndex:
    contigs: list[Contig]
    l_pac: int                 # forward reference length
    pac_words: np.ndarray      # uint32, forward ref 2-bit packed (16/word)
    primary: int
    L2: np.ndarray             # int64[5]: L2[c] = 1 + #symbols<c; L2[4]=N+1
    cp: np.ndarray             # int32 [nblocks, 8] fused occ checkpoints
    sa_ls: np.ndarray          # uint32 [N+1] suffix array low words
    sa_ms: np.ndarray          # uint8  [N+1] suffix array high bytes
    holes: np.ndarray          # int64 [n,2] ambiguous-base runs (fwd coords)
    cp_hi: np.ndarray | None = None  # int32 [nblocks, 4] high words of the
    #                            occ counts — present only for >=2^31 texts
    #                            (cp cols 0..3 then hold the LOW 32 bits)

    @property
    def sa(self) -> np.ndarray:
        """Full-resolution suffix array, int64 (host view; combines the
        5-byte split storage — tests and host-side tooling only)."""
        return (self.sa_ms.astype(np.int64) << 32) | self.sa_ls.astype(
            np.int64)

    @property
    def seq_len(self) -> int:
        return 2 * self.l_pac

    # ---------------- build ----------------

    @classmethod
    def build(cls, contigs: list[Contig], codes: np.ndarray,
              holes: np.ndarray | None = None,
              use_native: bool | None = None) -> "FMIndex":
        """The index of `codes`; ``use_native`` picks the suffix-array
        construction (``index.sais.suffix_array``: None or True, SA-IS in
        the native library, raising when it cannot be built; False, NumPy
        prefix doubling)."""
        l_pac = int(codes.size)
        if 2 * l_pac >= 1 << 40:
            raise ValueError("reference exceeds the 5-byte SA layout (2^40)")
        rc = (3 - codes[::-1]).astype(np.uint8)
        seq = np.concatenate([codes, rc])
        n = seq.size
        sa = suffix_array(seq, use_native=use_native)
        bwt, primary = bwt_and_primary(seq, sa)

        counts = np.bincount(seq, minlength=4).astype(np.int64)
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)
        L2 += 1  # sentinel occupies rank 0
        L2[0] = 1

        cp, cp_hi = cls._build_checkpoints(bwt, n)
        return cls(
            cp_hi=cp_hi,
            contigs=contigs,
            l_pac=l_pac,
            pac_words=pack_2bit(codes),
            primary=primary,
            L2=L2,
            cp=cp,
            sa_ls=(sa & 0xFFFFFFFF).astype(np.uint32),
            sa_ms=(sa >> 32).astype(np.uint8),
            holes=holes if holes is not None else np.zeros((0, 2), np.int64),
        )

    @classmethod
    def from_fasta(cls, path: str,
                   use_native: bool | None = None) -> "FMIndex":
        contigs, codes, holes = read_fasta(path)
        return cls.build(contigs, codes, holes, use_native=use_native)

    @staticmethod
    def _build_checkpoints(bwt: np.ndarray, n: int
                           ) -> tuple[np.ndarray, np.ndarray | None]:
        """Fused checkpoints; for texts >= 2^31 the cumulative counts
        overflow int32, so cp cols 0..3 store the LOW words and a second
        int32 [nblocks, 4] carries the high words (cp_hi)."""
        wide = n + 1 >= 1 << 31
        nblocks = n // CP_BLOCK + 1
        cp = np.zeros((nblocks, 8), dtype=np.int32)
        # cumulative counts at block starts, via per-block counts (memory-
        # lean: O(nblocks) int64, not an O(n) cumsum — n is 6.2e9 at
        # GRCh38); int64 accumulate since a >=2^31 text overflows int32
        padded = np.full(nblocks * CP_BLOCK, 4, dtype=np.uint8)
        padded[:n] = bwt
        blocks = padded.reshape(nblocks, CP_BLOCK)
        csum64 = np.empty((4, nblocks - 1), dtype=np.int64)
        for c in range(4):
            per_blk = np.count_nonzero(blocks == c, axis=1)
            csum64[c] = np.cumsum(per_blk.astype(np.int64))[:-1]
        cp_hi = None
        if wide:
            cp_hi = np.zeros((nblocks, 4), dtype=np.int32)
            cp_hi[1:, :] = (csum64 >> 32).T.astype(np.int32)
            cp[1:, 0:4] = (csum64 & 0xFFFFFFFF).T.astype(
                np.uint32).view(np.int32)
        else:
            cp[1:, 0:4] = csum64.T.astype(np.int32)
        # packed bwt words per block (4 uint32 words = 64 codes)
        padded = np.zeros(nblocks * CP_BLOCK, dtype=np.uint8)
        padded[:n] = bwt
        words = pack_2bit(padded).reshape(nblocks, 4)
        cp[:, 4:8] = words.view(np.int32)
        return cp, cp_hi

    # ---------------- host queries (reference semantics) ----------------

    def occ_stored(self, c: int, i: int) -> int:
        """# of code c in stored bwt[0:i) — host scalar, for tests."""
        b, off = divmod(i, CP_BLOCK)
        base = int(self.cp[b, c])
        if off == 0:
            return base
        words = self.cp[b, 4:8].view(np.uint32)
        codes = unpack_2bit(words, off)
        return base + int(np.count_nonzero(codes == c))

    def occ_full(self, c: int, i: int) -> int:
        """# of code c in BWT_full[0:i), i in [0, N+1]."""
        return self.occ_stored(c, i - (1 if i > self.primary else 0))

    def fetch_ref(self, rb: int, re: int) -> np.ndarray:
        """Reference codes for [rb, re) in 2*l_pac coordinates (host)."""
        assert 0 <= rb <= re <= self.seq_len
        if re <= self.l_pac:  # fast path: entirely forward strand
            return self._fwd_codes(np.arange(rb, re))
        if rb >= self.l_pac:  # entirely reverse strand
            p = np.arange(2 * self.l_pac - re, 2 * self.l_pac - rb)
            return (3 - self._fwd_codes(p))[::-1]
        out = np.empty(re - rb, dtype=np.uint8)
        pos = np.arange(rb, re)
        fwd = pos < self.l_pac
        out[fwd] = self._fwd_codes(pos[fwd])
        p = 2 * self.l_pac - 1 - pos[~fwd]
        out[~fwd] = 3 - self._fwd_codes(p)
        return out

    def _fwd_codes(self, p: np.ndarray) -> np.ndarray:
        w = self.pac_words[p >> 4]
        return ((w >> ((p & 15).astype(np.uint32) * 2)) & 3).astype(np.uint8)

    def depos(self, rb: int, re: int) -> tuple[bool, int, int]:
        """Map [rb, re) in 2*l_pac space to (is_rev, fwd_rb, fwd_re)."""
        is_rev = rb >= self.l_pac
        if is_rev:
            rb, re = 2 * self.l_pac - re, 2 * self.l_pac - rb
        return is_rev, rb, re

    def pos_to_rid(self, pos: int) -> int:
        """Contig id for a forward-coordinate position; -1 if out of range."""
        if pos < 0 or pos >= self.l_pac:
            return -1
        offs = getattr(self, "_offs", None)
        if offs is None:
            offs = np.array([c.offset for c in self.contigs], dtype=np.int64)
            self._offs = offs
        return int(np.searchsorted(offs, pos, side="right") - 1)

    # ---------------- persistence ----------------

    def save(self, prefix: str) -> None:
        meta = {
            "version": 1,
            "l_pac": self.l_pac,
            "primary": self.primary,
            "contigs": [dataclasses.asdict(c) for c in self.contigs],
        }
        arrays = dict(
            pac_words=self.pac_words,
            L2=self.L2,
            cp=self.cp,
            sa_ls=self.sa_ls,
            sa_ms=self.sa_ms,
            holes=self.holes,
        )
        if self.cp_hi is not None:
            arrays["cp_hi"] = self.cp_hi
        np.savez(prefix + INDEX_SUFFIX + ".npz", **arrays)
        with open(prefix + INDEX_SUFFIX + ".json", "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        with open(prefix + INDEX_SUFFIX + ".json") as f:
            meta = json.load(f)
        z = np.load(prefix + INDEX_SUFFIX + ".npz")
        if "sa_ls" in z:
            sa_ls, sa_ms = z["sa_ls"], z["sa_ms"]
        else:  # version-1 archives stored a full int32 SA
            sa = z["sa"].astype(np.int64)
            sa_ls = (sa & 0xFFFFFFFF).astype(np.uint32)
            sa_ms = (sa >> 32).astype(np.uint8)
        return cls(
            contigs=[Contig(**c) for c in meta["contigs"]],
            l_pac=meta["l_pac"],
            pac_words=z["pac_words"],
            primary=meta["primary"],
            L2=z["L2"],
            cp=z["cp"],
            sa_ls=sa_ls,
            sa_ms=sa_ms,
            holes=z["holes"],
            cp_hi=z["cp_hi"] if "cp_hi" in z else None,
        )

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(prefix + INDEX_SUFFIX + ".json")
