"""The comparison that decides ``correct``: the SAM the timed path wrote,
against the reads that were offered and the reference genome.

It imports nothing of the program.  The reads of a batch are made again
from (seed, stream, batch) by ``portbench.gen.reads``; the genome is the
harness's own index text (``portbench.gen.genomes``).  Every number is a
count or a share of reads; ``numbers`` returns them by name.

- ``unanswered`` (all reads of the window): reads offered without exactly
  one primary record, in the order offered (a read is one mate of a pair).
- ``altered`` (the sample): primary records whose SEQ or QUAL is not the
  read offered (reverse-complemented where flag 16 says so).
- ``sam_fields`` (the sample): primary records that break a rule of SAM as
  bwa writes it: the CIGAR spans the read; NM is the CIGAR's edit count on
  the genome at POS, plus the length of a deletion that bwa squeezed out
  of either end of the CIGAR (and left in NM and MD: ``squeezed``); MAPQ
  lies in [0, 60]; a record with XS >= AS has MAPQ 0, where it is a single
  end or a mate without flag 2, and at most 40 where it is a mate with flag
  2 (bwa's ``mem_approx_mapq_se`` gives 0 once the second best reaches the
  best, and pairing raises that by 40 at most); a mate's flags 1, 8, 32,
  64/128, RNEXT, PNEXT and TLEN agree with the other mate's record.
- ``misaligned_pct`` (the sample): reads whose reported alignment (its
  CIGAR's score on the genome at POS, less the clipping penalty of each
  clipped end) lies below the best that the bases the read was cut from
  offer (``dp.best_clipped``); that are unmapped though that best reaches
  the output threshold T; or whose CIGAR's score lies above AS or further
  below it than the clipping penalties of its unclipped ends allow
  (``_end_pens``).
- ``mapq0_unique_pct`` (the sample): of the reads placed uniquely at a
  score their true origin allows (not misaligned, and the second best,
  ``max(XS, min_seed_len * a)``, at most half of AS), the share with MAPQ
  0.  bwa's MAPQ of such a read is 6.02 * (AS - sub) scaled by its
  identity, far above 0, unless its seeds were repetitive (``frac_rep``).
- ``mispaired_pct`` (pairs only; the sample): of the pairs whose two ends
  both reach T at their true origins and whose true insert lies within
  three standard deviations of the mix's mean (bwa infers its proper
  range from the batch: wider than that), the share whose records are not
  a proper pair: an end unmapped or without flag 2, on one strand, on two
  contigs, the forward end's TLEN not positive, or |TLEN| past the mean
  plus six standard deviations.
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as np
import torch

from portbench.gen.reads import make_batch
from portbench.reference.dp import best_clipped

PAD = 40            # window bases on each side of a read's true origin
MAX_EXAMPLES = 8    # failing records kept for the run's stderr
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
_CODE = bytes.maketrans(b"ACGTN", bytes([0, 1, 2, 3, 4]))


def primaries(text: str):
    """(QNAME, flag, fields) of every primary record in `text`."""
    for line in text.split("\n"):
        if not line or line[0] == "@":
            continue
        f = line.split("\t")
        flag = int(f[1])
        if not flag & 0x900:
            yield f[0], flag, f


def expected_names(stream: int, n_batches: int, traffic: dict) -> list:
    """(QNAME, end) of every read offered, in the order a SAM lists them."""
    ends = int(traffic["ends"])
    return [(f"s{stream}b{k}r{i}", e) for k in range(n_batches)
            for i in range(int(traffic["batch_reads"])) for e in range(ends)]


def end_of(flag: int, ends: int) -> int:
    return 0 if ends == 1 else (1 if flag & 0x80 else 0)


def unanswered(records: list, expected: list) -> int:
    """Reads without exactly one primary record, records of reads never
    offered, and records out of order."""
    got = [(q, e) for q, e in records]
    if got == expected:
        return 0
    cnt = Counter(got)
    want = set(expected)
    missing = sum(1 for x in expected if cnt[x] == 0)
    dup = sum(c - 1 for x, c in cnt.items() if c > 1 and x in want)
    extra = sum(c for x, c in cnt.items() if x not in want)
    if missing or dup or extra:
        return missing + dup + extra
    return sum(a != b for a, b in zip(got, expected))


def _tags(fields: list) -> dict:
    out = {}
    for t in fields[11:]:
        if t[2:5] == ":i:":
            out[t[:2]] = int(t[5:])
    return out


def _ops(cigar: str) -> list:
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def squeezed(fields: list) -> int:
    """Bases of a deletion at either end of the alignment that bwa dropped
    from the CIGAR (``mem_reg2aln``) but kept in MD (``0^ACG...`` first,
    ``...^ACG0`` last) and in NM."""
    md = next((t[5:] for t in fields[11:] if t.startswith("MD:Z:")), "")
    lead = re.match(r"0\^([A-Z]+)", md)
    trail = re.search(r"\^([A-Z]+)0$", md)
    return (len(lead.group(1)) if lead else 0) + \
        (len(trail.group(1)) if trail else 0)


def _ref_len(ops) -> int:
    return sum(n for n, op in ops if op in "MDN=X")


def cigar_score(ops, seq: bytes, ref: np.ndarray, pos0: int,
                sc: dict) -> tuple[int, int]:
    """(score, edit count) of the CIGAR's aligned part at 0-based `pos0`."""
    codes = np.frombuffer(seq.translate(_CODE), dtype=np.uint8)
    score = nm = 0
    qi, ri = 0, pos0
    for n, op in ops:
        if op in "M=X":
            q = codes[qi:qi + n]
            r = ref[ri:ri + n]
            if r.size != n:
                return -(1 << 30), -1
            same = (q == r) & (q < 4)
            amb = (q > 3) | (r > 3)
            mism = int(n - same.sum() - amb.sum())
            score += int(same.sum()) * sc["a"] - mism * sc["b"] - int(amb.sum())
            nm += n - int(same.sum())
            qi += n
            ri += n
        elif op == "I":
            score -= sc["o_ins"] + n * sc["e_ins"]
            nm += n
            qi += n
        elif op == "D":
            score -= sc["o_del"] + n * sc["e_del"]
            nm += n
            ri += n
        elif op == "S":
            qi += n
    return score, nm


def _end_pens(ops, rev: bool, sc: dict) -> tuple[int, int]:
    """(clipping penalty of the clipped ends, room of the unclipped ends).

    bwa's AS is its extension's local best; an end is extended to the read's
    end where that scores above the local best less the end's clipping
    penalty, so an unclipped end's score lies less than that penalty below
    the local best (the room: penalty - 1)."""
    lead = bool(ops) and ops[0][1] in "SH"
    trail = bool(ops) and ops[-1][1] in "SH"
    # on the reverse strand the CIGAR's first clip is the read's 3' end
    p_lead, p_trail = ((sc["pen_clip3"], sc["pen_clip5"]) if rev
                       else (sc["pen_clip5"], sc["pen_clip3"]))
    pen = lead * p_lead + trail * p_trail
    room = (not lead) * (p_lead - 1) + (not trail) * (p_trail - 1)
    return pen, room


def _improper(f0: list, f1: list, max_tlen: float) -> str | None:
    """Why two mates' records are not a proper pair, or None."""
    fl0, fl1 = int(f0[1]), int(f1[1])
    if (fl0 | fl1) & 4:
        return "an end unmapped"
    if not fl0 & fl1 & 2:
        return "no flag 2"
    if bool(fl0 & 16) == bool(fl1 & 16):
        return "ends on one strand"
    if f0[2] != f1[2]:
        return "ends on two contigs"
    fwd = f0 if not fl0 & 16 else f1
    tlen = int(fwd[8])
    if not 0 < tlen <= max_tlen:
        return f"forward end's TLEN {tlen}"
    return None


class Reference:
    """The genome (index text), the traffic and the configuration's scoring;
    ``check`` judges a window's SAM."""

    def __init__(self, text: np.ndarray, contig: str, traffic: dict,
                 scoring: dict, device: str = "cpu"):
        self.text = text
        self.contig = contig
        self.traffic = traffic
        self.sc = scoring
        self.device = device

    def check(self, sam_text: str, seed: int, stream: int, n_batches: int,
              sample: list) -> dict:
        ends = int(self.traffic["ends"])
        recs = {}
        order = []
        for q, flag, f in primaries(sam_text):
            key = (q, end_of(flag, ends))
            order.append(key)
            recs.setdefault(key, f)
        out = {"unanswered": unanswered(
            order, expected_names(stream, n_batches, self.traffic))}
        self.examples = []
        tot = Counter()
        for k in sample:
            b = make_batch(self.text, self.traffic, seed, stream, k)
            tot.update(self._batch(b, recs, ends))
        out["altered"] = tot["altered"]
        out["sam_fields"] = tot["sam_fields"]
        out["misaligned_pct"] = 100.0 * tot["misaligned"] / max(tot["reads"],
                                                                1)
        out["mapq0_unique_pct"] = (100.0 * tot["mapq0_unique"]
                                   / max(tot["unique"], 1))
        if ends == 2:
            out["mispaired_pct"] = (100.0 * tot["mispaired"]
                                    / max(tot["pairs"], 1))
            out["checked_pairs"] = tot["pairs"]
        out["sampled_reads"] = tot["reads"]
        out["examples"] = self.examples
        return out

    def _batch(self, b, recs: dict, ends: int) -> dict:
        sc = self.sc
        n = len(b.names)
        res = Counter()
        best = self._truth_best(b)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        for e in range(ends):
            for i in range(n):
                f = recs.get((b.names[i], e))
                if f is None:
                    continue      # counted by `unanswered`
                res["reads"] += 1
                flag = int(f[1])
                L = int(b.lens[e, i])
                offered = lut[b.codes[e, i, :L] & 3].tobytes()
                seq = f[9].encode()
                rev = bool(flag & 16)
                want = offered.translate(_COMP)[::-1] if rev else offered
                if seq != want or f[10] != "I" * L:
                    self._fault(res, "altered", "seq", f)
                rule = (self._mate_fields(f, recs.get((b.names[i], 1 - e)),
                                          e) if ends == 2 else None)
                if flag & 4:
                    if best[e, i] >= sc["T"]:
                        self._fault(res, "misaligned", "unmapped", f)
                    if rule:
                        self._fault(res, "sam_fields", rule, f)
                    continue
                ops = _ops(f[5])
                tags = _tags(f)
                mapq = int(f[4])
                s, nm = cigar_score(ops, seq, self.text, int(f[3]) - 1, sc)
                if sum(m for m, op in ops if op in "MIS=XH") != L:
                    rule = "cigar_span"
                elif f[2] != self.contig:
                    rule = "contig"
                elif not 0 <= mapq <= 60:
                    rule = "mapq_range"
                elif tags.get("XS", -1) >= tags.get("AS", 0) and mapq > (
                        40 if ends == 2 and flag & 2 else 0):
                    rule = "mapq_xs"
                elif nm + squeezed(f) != tags.get("NM", -1):
                    rule = "nm"
                if rule:
                    self._fault(res, "sam_fields", rule, f)
                pen, room = _end_pens(ops, rev, sc)
                if s - pen < best[e, i]:
                    self._fault(res, "misaligned",
                                f"score {s - pen} < truth {best[e, i]}", f)
                elif "AS" not in tags or not 0 <= tags["AS"] - s <= room:
                    self._fault(res, "misaligned", f"cigar score {s} vs AS", f)
                elif 2 * max(tags.get("XS", 0),
                             sc["min_seed_len"] * sc["a"]) <= tags["AS"]:
                    res["unique"] += 1
                    if mapq == 0:
                        self._fault(res, "mapq0_unique", "unique, MAPQ 0", f)
        if ends == 2:
            self._pairs(b, recs, best, res)
        return res

    def _pairs(self, b, recs: dict, best: np.ndarray, res: dict) -> None:
        """Count the pairs that bwa's insert model makes proper and the
        records that do not say so (``mispaired_pct``)."""
        L = int(self.traffic["read_len"])
        mean = float(self.traffic["isize_mean"])
        std = float(self.traffic["isize_std"])
        isize = np.abs(b.pos[0].astype(np.int64) - b.pos[1]) + L
        due = ((best[0] >= self.sc["T"]) & (best[1] >= self.sc["T"])
               & (np.abs(isize - mean) <= 3 * std))
        for i in np.flatnonzero(due).tolist():
            f0, f1 = recs.get((b.names[i], 0)), recs.get((b.names[i], 1))
            if f0 is None or f1 is None:
                continue      # counted by `unanswered`
            res["pairs"] += 1
            rule = _improper(f0, f1, mean + 6 * std)
            if rule:
                self._fault(res, "mispaired", rule, f0)

    def _fault(self, res: dict, kind: str, rule: str, f: list) -> None:
        res[kind] += 1
        if len(self.examples) < MAX_EXAMPLES:
            self.examples.append(f"{kind} {rule}: " + "\t".join(f)[:300])

    def _mate_fields(self, f: list, m: list | None, e: int) -> str | None:
        """The bwa rule that the record's mate fields break, or None."""
        if m is None:
            return None   # counted by `unanswered`
        flag, mflag = int(f[1]), int(m[1])
        if not flag & 1 or bool(flag & 0x40) != (e == 0) or \
                bool(flag & 0x80) != (e == 1):
            return "mate_flags"
        if bool(flag & 8) != bool(mflag & 4):
            return "mate_unmapped_flag"
        if m[2] == "*":
            return (None if (f[6], f[7], f[8]) == ("*", "0", "0")
                    else "mate_fields_unplaced")
        if bool(flag & 32) != bool(mflag & 16):
            return "mate_reverse_flag"
        rnext = m[2] if f[6] == "=" else f[6]
        if (f[6] == "=") != (f[2] == m[2]) or rnext != m[2] or f[7] != m[3]:
            return "rnext_pnext"
        if flag & 4 or mflag & 4 or f[2] != m[2]:
            return None if f[8] == "0" else "tlen"
        po, mo = _ops(f[5]), _ops(m[5])
        p0 = int(f[3]) + (_ref_len(po) - 1 if flag & 16 else 0)
        p1 = int(m[3]) + (_ref_len(mo) - 1 if mflag & 16 else 0)
        tlen = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
        return None if int(f[8]) == tlen else f"tlen want {tlen}"

    def _truth_best(self, b) -> np.ndarray:
        """[ends, n] best clip-penalised score at each read's origin."""
        ends, n, L = b.codes.shape
        t = L + 2 * PAD
        out = np.empty((ends, n), dtype=np.int64)
        for e in range(ends):
            lo = b.pos[e] - PAD
            idx = np.clip(lo[:, None] + np.arange(t)[None, :], 0,
                          self.text.size - 1)
            win = np.asarray(self.text)[idx]
            # window bases off the genome match nothing
            win = np.where((lo[:, None] + np.arange(t)[None, :] < 0)
                           | (lo[:, None] + np.arange(t)[None, :]
                              >= self.text.size), 4, win)
            reads = torch.as_tensor(b.forward(e), device=self.device)
            best = best_clipped(
                reads, torch.as_tensor(b.lens[e], device=self.device),
                torch.as_tensor(win, device=self.device), self.sc)
            out[e] = best.cpu().numpy()
        return out
