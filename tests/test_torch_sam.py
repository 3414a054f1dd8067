"""End-to-end SAM through the port on the CPU.

* ``align_fastq`` reproduces tests/golden/se.sam byte for byte on the
  fixture and batch size of tests/test_golden_sam.py (@PG stripped).
* The gates of tests/test_realistic_fixture.py (N-islands, STRs, GC
  isochores): one primary per read, mapping-rate floors, an all-N read
  unmapped — and the port's SAM text equals the JAX Aligner's on it.
* The native emitter (``flatsam.emit_flat``) on a worst-case lane of the
  wide windows: its NM and MD equal ``cigar_nm_md``'s; a lane past the
  MD buffer raises, naming its record.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch

from tpubwa.config import MemOptions
from tpubwa.index.fmindex import FMIndex

sys.path.insert(0, os.path.dirname(__file__))
from test_golden_sam import GOLDEN_DIR, _build_fixture, _strip_pg  # noqa: E402

torch.set_num_threads(1)

LENGTH = 200_000
N_READS = 160


def test_golden_se_sam_byte_for_byte(tmp_path):
    from tpubwa_torch.align.pipeline import align_fastq

    ref, se_fq, _, _ = _build_fixture(str(tmp_path))
    buf = io.StringIO()
    assert align_fastq(ref, se_fq, None, buf, device="cpu",
                       batch_reads=64) == 0
    with open(os.path.join(GOLDEN_DIR, "se.sam")) as f:
        assert _strip_pg(buf.getvalue()) == f.read()


@pytest.fixture(scope="module")
def realistic(tmp_path_factory):
    """tests/test_realistic_fixture.py's genome and reads."""
    from tpubwa.io.fasta import read_fasta
    from tpubwa.utils import sim
    from tpubwa.utils.dna import decode, revcomp_codes
    from tpubwa.utils.simgenome import realistic_genome

    codes = realistic_genome(np.random.default_rng(77), LENGTH)
    d = tmp_path_factory.mktemp("realg")
    fa = str(d / "realg.fa")
    with open(fa, "w") as f:
        f.write(">rg1\n")
        seq = decode(codes)
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")
    FMIndex.from_fasta(fa).save(fa)
    _, codes2, holes = read_fasta(fa)
    assert len(holes) >= 5
    ok = np.lib.stride_tricks.sliding_window_view(codes2 < 4, 150).all(1)
    good_pos = np.nonzero(ok)[0]
    reads = []
    rr = np.random.default_rng(9)
    for i in range(N_READS):
        pos = int(good_pos[rr.integers(0, len(good_pos))])
        strand = int(rr.integers(0, 2))
        s = sim._mutate(rr, codes2[pos:pos + 150].copy(), 0.01, 0.001, 150)
        if strand:
            s = revcomp_codes(s)
        reads.append((f"sim_{i}_0_{pos}_{strand}", decode(s), "I" * len(s)))
    fq = str(d / "r.fq")
    sim.write_fastq(fq, reads)
    return FMIndex.load(fa), reads, fq


def test_realistic_gates_through_port(realistic):
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    idx, reads, fq = realistic
    out = io.StringIO()
    run_se_pipeline(Aligner(idx, MemOptions(batch_reads=64), device="cpu"),
                    fq, out)
    prim = {}
    for line in out.getvalue().splitlines():
        f = line.split("\t")
        if int(f[1]) & 0x900:
            continue
        assert f[0] not in prim, "duplicate primary"
        prim[f[0]] = (int(f[1]), f[2], int(f[3]))
    assert len(prim) == N_READS
    mapped = [(n, p) for n, (fl, r, p) in prim.items() if not fl & 4]
    near = sum(abs(p - 1 - int(n.split("_")[3])) <= 50 for n, p in mapped)
    assert len(mapped) >= int(0.97 * N_READS)
    assert near >= int(0.92 * N_READS)


def test_realistic_sam_matches_jax_and_n_reads(realistic):
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.io.fastq import Read, batch_reads
    from tpubwa_torch.align.pipeline import Aligner

    idx, reads, _ = realistic
    rr = [Read(*r) for r in reads[:94]] + [
        Read("nread", "N" * 150, "I" * 150),
        Read("polya", "A" * 150, "I" * 150)]
    batch = next(batch_reads(rr, 96, 160))
    got = Aligner(idx, MemOptions(batch_reads=96),
                  device="cpu").align_se_text(batch, 0)
    want = JaxAligner(idx, MemOptions(batch_reads=96)).align_se_text(batch, 0)
    assert got == want
    rows = {ln.split("\t")[0]: ln.split("\t") for ln in got.splitlines()
            if not int(ln.split("\t")[1]) & 0x900}
    assert int(rows["nread"][1]) & 4
    assert "polya" in rows


def _emit_lanes(lanes):
    """Render one record a lane through ``flatsam.emit_flat``; each lane
    is (query codes, window codes, the cigar before the squeeze as
    (op, len), lead and trail deletions counted in it)."""
    import types

    from tpubwa_torch.align import flatsam
    from tpubwa_torch.io.fasta import Contig
    from tpubwa_torch.utils.dna import decode

    n = len(lanes)
    qw = max(q.size for q, _, _ in lanes)
    tw = max(t.size for _, t, _ in lanes)
    qh = np.full((n, qw), 4, np.int8)
    th = np.full((n, tw), 4, np.int8)
    segs = np.zeros((n, flatsam.GA_K), np.int32)
    core = {k: np.zeros(n, np.int32) for k in (
        "rid", "clip5", "clip3", "nseg", "lead_d", "trail_d", "lq", "rlen",
        "win_row")}
    for i, (q, t, cig) in enumerate(lanes):
        qh[i, :q.size], th[i, :t.size] = q, t
        lead = cig[0][1] if cig[0][0] == 2 else 0
        trail = cig[-1][1] if cig[-1][0] == 2 else 0
        mid = cig[(1 if lead else 0):len(cig) - (1 if trail else 0)]
        segs[i, :len(mid)] = [(ln << 2) | op for op, ln in mid]
        core["nseg"][i], core["lead_d"][i] = len(mid), lead
        core["trail_d"][i], core["lq"][i], core["rlen"][i] = trail, q.size, \
            t.size
        core["win_row"][i] = i
    core.update(rev=np.zeros(n, bool), p1=np.full(n, 1_001, np.int64),
                segs=segs, nm_in=np.full(n, -1, np.int32),
                mm_pos=np.zeros((n, flatsam.MM_K), np.uint8),
                mm_let=np.zeros((n, flatsam.MM_K), np.uint8), qh=qh, th=th)
    z32 = np.zeros(n, np.int32)
    rec = dict(b=np.arange(n), lane=np.arange(n), flag=z32, mapq=z32 + 60,
               score=z32 + 10, xs=z32, rnext=z32 - 1,
               pnext=np.zeros(n, np.int64), tlen=np.zeros(n, np.int64),
               alt_lo=z32, alt_hi=z32)
    al = types.SimpleNamespace(idx=types.SimpleNamespace(
        contigs=[Contig("c0", 100_000, 0)]))
    names = [f"r{i}" for i in range(n)]
    seqs = [decode(q) for q, _, _ in lanes]
    return flatsam.emit_flat(al, names, seqs, ["I" * len(x) for x in seqs],
                             [""] * n, core, rec)


def _mismatched_lane(rng, cig):
    """A query that mismatches its window at every aligned base."""
    tlen = sum(ln for op, ln in cig if op != 1)
    t = rng.integers(0, 4, tlen).astype(np.int8)
    q, ti = [], 0
    for op, ln in cig:
        if op == 0:
            q.extend((t[ti:ti + ln] + rng.integers(1, 4, ln)) % 4)
        if op != 1:
            ti += ln
    return np.array(q, np.int8), t, cig


def test_emitter_worst_case_wide_lane():
    """A 256-base query on a 384-base window, every aligned base a
    mismatch, deletions inside and squeezed at both ends."""
    from tpubwa_torch.config import WIDE
    from tpubwa_torch.ops.global_align import cigar_nm_md

    cig = [(2, 16), (0, 64), (2, 48), (0, 64), (2, 48), (0, 128), (2, 16)]
    q, t, _ = lane = _mismatched_lane(np.random.default_rng(3), cig)
    assert (q.size, t.size) == (WIDE.sam_q, WIDE.sam_t)
    f = _emit_lanes([lane]).rstrip("\n").split("\t")
    nm, md = cigar_nm_md(q, t, cig)
    assert f[5] == "64M48D64M48D128M"
    assert f[11:13] == [f"NM:i:{nm}", f"MD:Z:{md}"]
    assert nm == 256 + 128 and 640 < len(md) < 900


def test_emitter_md_overflow_names_the_record():
    rng = np.random.default_rng(4)
    small = _mismatched_lane(rng, [(0, 150)])
    huge = _mismatched_lane(rng, [(0, 2_500)])
    with pytest.raises(RuntimeError, match=r"record 1 \(read r1\)"):
        _emit_lanes([small, huge])
