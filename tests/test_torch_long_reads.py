"""Reads of 161-256 bp on the port's normal path, on the CPU.

A batch whose longest read is at most ``max_read_len`` (160) runs at the
narrow bucket's widths, as before; a batch holding a longer read, up to
``LONG_READ_LEN`` (256, 2x250 Illumina), runs at the wide bucket's
(``config.Widths``), every read of it padded to 256.

(a) 200- and 250-bp SE reads and pairs of ``portbench.gen.reads`` on a
    200 kb repeat-rich genome of ``portbench.gen.genomes`` through
    ``run_se_pipeline`` / ``align_pe_fastq``: the benchmark's plain
    reference (``portbench.reference.check``) finds every read answered,
    none altered, no SAM rule broken, and the misaligned and mispaired
    shares within the limits of the cell ``chr21_sim.pe250``; every batch
    ran at the wide widths.
(b) Extension jobs whose query sides are 193-249 bases: the flat engine
    (``ops.extend_flat.extend_jobs`` at the wide query window) equals the
    scalar oracle ``ops.extend_ref.extend_ref`` on the whole sides.
(c) A mate rescue whose window is longer than 1,024 bases:
    ``run_matesw_rounds`` at the wide pads rescues what the scalar local
    SW (``ops.localsw.localsw_ref``) on the whole query and window
    rescues, and cuts nothing (``pair.rescue_truncated`` 0).
(d) Batches of reads of at most 160 bp run at the narrow bucket's exact
    widths, and their SAM equals the JAX package's byte for byte, on
    ``test_torch_flat.py``'s and ``test_torch_pe.py``'s inputs.
(e) A 257-bp read is reported unmapped with a warning, in a wide batch
    and in a narrow one.
(f) The other serving modes on a wide batch: a device mesh, ``--chunks``,
    ``-t 2`` and the per-read path give the flat engine's output (they
    follow the bucket); ``device_align_step`` raises.
"""
import copy
import dataclasses
import io
import json
import os
import sys
from contextlib import contextmanager, redirect_stderr

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpubwa_torch.config import (LONG_READ_LEN, NARROW, WIDE,  # noqa: E402
                                 MemOptions)

torch.set_num_threads(1)

GENOME = 200_000
BATCH = 40
# a PE batch large enough for bwa's insert model (pestat, inferred from
# the batch) to be as wide as the check assumes: 40 pairs can give a
# proper range narrower than the mix's mean +- 3 sd
PE_BATCH = 128
SEED = 3_700_000_123


def _json(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "chr21_sim_2x250.json")
PE250 = _json("traffic", "pe250.json")
LIMITS = _json("cells", "chr21_sim.pe250.json")["limits"]
OPT = MemOptions(**CONFIG["mem_options"])
MAT = OPT.score_matrix()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
            e_ins=OPT.e_ins)


@contextmanager
def recorded_widths():
    """Every width the aligner's device calls get, by name: the seeding
    capacities, the extension query window, the flat SAM windows, the
    rescue pads and the codes' width."""
    from tpubwa_torch.align import flatext, flatsam, pair, pipeline

    seen = {k: set() for k in ("L", "smems", "seeds", "rows", "ext_q",
                               "sam", "rescue")}
    wraps = {
        (pipeline, "collect_smems_mesh"):
            lambda a, k: seen["smems"].add(k["out_cap"])
            or seen["L"].update(c.shape[1] for c in a[1]),
        (pipeline, "seed_rows_mesh"):
            lambda a, k: seen["seeds"].add(k["per_read_cap"])
            or seen["rows"].add(k["rows_per_read"]),
        (flatext, "extend_jobs"): lambda a, k: seen["ext_q"].add(k["q_pad"]),
        (flatext, "extend_jobs_left"):
            lambda a, k: seen["ext_q"].add(k["q_pad"]),
        (flatext, "extend_jobs_right"):
            lambda a, k: seen["ext_q"].add(k["q_pad"]),
        (flatsam, "_flat_windows"):
            lambda a, k: seen["sam"].add((k["q_pad"], k["t_win"])),
        (pair, "rescue_batch"):
            lambda a, k: seen["rescue"].add((k["q_pad"], k["t_pad"])),
    }
    orig = {key: getattr(*key) for key in wraps}

    def wrap(key):
        def f(*a, **k):
            wraps[key](a, k)
            return orig[key](*a, **k)
        return f

    try:
        for key in wraps:
            setattr(*key, wrap(key))
        yield seen
    finally:
        for key, fn in orig.items():
            setattr(*key, fn)


def bucket_of(widths, opt=OPT) -> dict:
    """What ``recorded_widths`` records of a run at `widths`."""
    scale = widths.seed_scale
    return dict(smems={opt.max_smems_per_read * scale},
                seeds={opt.max_seeds_per_read * scale},
                rows={widths.seed_rows},
                ext_q={widths.ext_q}, sam={(widths.sam_q, widths.sam_t)},
                rescue={(widths.rescue_q, widths.rescue_t)})


def _same_bucket(seen, widths, pe: bool):
    want = bucket_of(widths)
    if not pe:
        del want["rescue"]
    got = {k: seen[k] for k in want}
    assert got == want


# ------------------------------------------------------------------ (a) --

@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 200 kb genome of the benchmark's realistic model (segmental
    copies, an Alu-like family, microsatellites, N islands), indexed as the
    benchmark indexes it; (FASTA path, index, index text)."""
    from portbench.gen.genomes import index_text, make_genome, write_fasta
    from tpubwa_torch.index.fmindex import FMIndex

    d = tmp_path_factory.mktemp("t_long")
    codes, mask = make_genome({"model": "realistic", "seed": 7,
                               "length": GENOME, "contig": "tiny"})
    fa = str(d / "ref.fa")
    write_fasta(fa, codes, mask, "tiny")
    idx = FMIndex.from_fasta(fa)
    idx.save(fa)
    return fa, idx, index_text(codes, mask)


def _traffic(ends: int, read_len: int, batch: int = BATCH) -> dict:
    return dict(PE250, ends=ends, read_len=read_len, batch_reads=batch)


def _fastqs(tmp_path, text, traffic, n_batches=2, stream=0):
    from portbench.gen.reads import make_batch

    paths = [str(tmp_path / f"r{e + 1}.fq") for e in range(traffic["ends"])]
    for e, p in enumerate(paths):
        with open(p, "wb") as f:
            for k in range(n_batches):
                f.write(make_batch(text, traffic, SEED, stream, k).fastq(e))
    return paths


def _align(idx, paths, opt=OPT, workers=1, batch=BATCH, **kw):
    from tpubwa_torch.align.pair import align_pe_fastq
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    al = Aligner(idx, dataclasses.replace(opt, batch_reads=batch),
                 device=kw.pop("device", "cpu"))
    out = io.StringIO()
    with redirect_stderr(io.StringIO()):
        if len(paths) == 1:
            run_se_pipeline(al, paths[0], out, workers=workers, **kw)
        else:
            assert align_pe_fastq(al, *paths, out, workers=workers,
                                  **kw) == 0
    return out.getvalue(), al


@pytest.mark.parametrize("ends,read_len", [(1, 200), (1, 250), (2, 200),
                                           (2, 250)],
                         ids=["se200", "se250", "pe200", "pe250"])
def test_long_reads_pass_the_benchmarks_check(genome, tmp_path, ends,
                                              read_len):
    from portbench.reference.check import Reference

    _, idx, text = genome
    batch, n_batches = (BATCH, 2) if ends == 1 else (PE_BATCH, 1)
    traffic = _traffic(ends, read_len, batch)
    paths = _fastqs(tmp_path, text, traffic, n_batches)
    with recorded_widths() as seen:
        sam, al = _align(idx, paths, batch=batch)
    assert seen["L"] == {LONG_READ_LEN}
    _same_bucket(seen, WIDE, pe=ends == 2)
    c = al.timers.counters
    assert c["fastq.wide_batches"] == n_batches
    assert c["pair.rescue_truncated"] == 0
    ref = Reference(text, "tiny", traffic, CONFIG["mem_options"])
    nums = ref.check(sam, SEED, 0, n_batches, list(range(n_batches)))
    assert nums["sampled_reads"] == n_batches * batch * ends
    assert (nums["unanswered"], nums["altered"], nums["sam_fields"]) == \
        (0, 0, 0), nums["examples"]
    for name in ("misaligned_pct", "mapq0_unique_pct", "mispaired_pct"):
        if name in nums:
            assert nums[name] <= LIMITS[name], (name, nums["examples"])
    if ends == 2:
        assert nums["checked_pairs"] >= batch // 2


# ------------------------------------------------------------------ (b) --

def _oracle_side(q, t, h0: int, bonus: int, prev: int):
    """``extend_ref`` with bwa's retry at double band (``_with_retry``):
    (result, band used)."""
    from tpubwa_torch.ops.extend_ref import extend_ref

    kw = dict(end_bonus=bonus, zdrop=OPT.zdrop, h0=h0, **GAPS)
    res = extend_ref(q, t, MAT, w=OPT.w, **kw)
    if res.score != prev and res.max_off >= (OPT.w >> 1) + (OPT.w >> 2):
        return extend_ref(q, t, MAT, w=2 * OPT.w, **kw), 2 * OPT.w
    return res, OPT.w


def test_flat_extension_equals_the_oracle_on_long_query_sides(genome):
    """Jobs from 250-bp reads whose left or right query side is 193-249
    bases (both sides at least one base): the flat engine at the wide
    bucket's query window against ``extend_ref`` (with bwa's band retry)
    on the whole sides and windows, every field of both sides and the
    bands used."""
    from tpubwa_torch.ops.extend_flat import T_PAD, extend_jobs
    from tpubwa_torch.ops.fm import DeviceIndex

    _, idx, _ = genome
    rng = np.random.default_rng(17)
    J, L = 48, 250
    text = idx.fetch_ref(0, idx.l_pac).astype(np.int32)
    starts = rng.integers(1000, idx.l_pac - 1000, J)
    reads = np.stack([text[s:s + L] for s in starts])
    mut = rng.random(reads.shape) < 0.03
    reads[mut] = (reads[mut] + 1) % 4
    codes = np.full((J, LONG_READ_LEN), 4, np.int32)
    codes[:, :L] = reads
    lens = np.full(J, L, np.int32)
    slen = rng.integers(19, 31, J).astype(np.int32)
    long_side = rng.integers(193, L - 31, J)
    qbeg = np.where(np.arange(J) % 2 == 0, long_side,
                    L - slen - long_side).astype(np.int32)
    rbeg = (starts + qbeg).astype(np.int64)
    rmax0 = rbeg - qbeg - rng.integers(0, 150, J)
    rmax1 = rbeg + (L - qbeg) + rng.integers(0, 150, J)
    h0 = slen.astype(np.int32)
    q_r = L - qbeg - slen
    assert (np.maximum(qbeg, q_r) > 192).all() and (np.minimum(qbeg, q_r)
                                                     >= 1).all()
    T = torch.as_tensor
    got = extend_jobs(
        DeviceIndex.from_host(idx, "cpu"), T(codes), T(lens),
        T(np.arange(J, dtype=np.int32)), T(qbeg), T(slen), T(rbeg),
        T(rmax0), T(rmax1), T(h0), T(MAT), zdrop=OPT.zdrop, mat_max=OPT.a,
        w0=OPT.w, pen_clip5=OPT.pen_clip5, pen_clip3=OPT.pen_clip3,
        q_pad=WIDE.ext_q, **GAPS).numpy()
    for j in range(J):
        qb, sl, rb = int(qbeg[j]), int(slen[j]), int(rbeg[j])
        left, aw0 = _oracle_side(
            reads[j, :qb][::-1], text[max(int(rmax0[j]), rb - T_PAD):rb][::-1],
            int(h0[j]), OPT.pen_clip5, -1)
        re0 = rb + sl
        right, aw1 = _oracle_side(
            reads[j, qb + sl:], text[re0:min(int(rmax1[j]), re0 + T_PAD)],
            left.score, OPT.pen_clip3, left.score)
        want = [*dataclasses.astuple(left), *dataclasses.astuple(right),
                aw0, aw1]
        assert got[:, j].tolist() == want, j


# ------------------------------------------------------------------ (c) --

def _rescue_case(genome):
    """An anchor on the forward strand, its 250-bp mate on the reverse
    strand at an insert of 1,090, and an insert model whose window (high
    - low + the mate) is 1,250 bases: longer than the narrow bucket's
    1,024, and the mate lies past that bucket's cut."""
    from tpubwa_torch.align.pair import PEStat
    from tpubwa_torch.align.region import AlnReg

    _, idx, text = genome
    l_pac = idx.l_pac
    a = AlnReg(rb=50_000, re=50_250, qb=0, qe=250, rid=0, score=250,
               truesc=250, secondary=-1)
    m0 = 50_840
    fwd = np.asarray(text[m0:m0 + 250]).astype(np.uint8).copy()
    rng = np.random.default_rng(5)
    mut = rng.random(250) < 0.08
    fwd[mut] = (fwd[mut] + 1) % 4
    ms = (3 - fwd)[::-1].copy()           # read 2: the reverse strand
    pes = [PEStat(failed=True), PEStat(low=100, high=1100, avg=600.0,
                                       std=100.0, failed=False),
           PEStat(failed=True), PEStat(failed=True)]
    assert pes[1].high - pes[1].low + ms.size > NARROW.rescue_t
    assert a.rb + pes[1].high + ms.size < l_pac
    return idx, a, ms, pes


def _plain_rescue(gen):
    """Drive a rescue generator with the scalar local SW on whole jobs."""
    from tpubwa_torch.ops.localsw import localsw_ref

    try:
        job = next(gen)
        while True:
            job = gen.send(localsw_ref(job.query, job.target, MAT,
                                       minsc=job.minsc, endsc=job.endsc,
                                       **GAPS))
    except StopIteration as e:
        return e.value


def test_rescue_at_the_wide_pads_equals_the_plain_local_sw(genome):
    from tpubwa_torch.align import pair
    from tpubwa_torch.utils.timers import PhaseTimers

    idx, a, ms, pes = _rescue_case(genome)
    want_ma, got_ma = [], []
    n_want = _plain_rescue(pair.matesw_gen(OPT, idx, pes, a, ms.size, ms,
                                           want_ma))
    timers = PhaseTimers()
    n_got = pair.run_matesw_rounds(
        OPT, [pair.matesw_gen(OPT, idx, pes, a, ms.size, ms, got_ma)],
        torch.as_tensor(MAT), q_pad=WIDE.rescue_q, t_pad=WIDE.rescue_t,
        timers=timers)
    assert n_got == n_want == 1
    assert len(want_ma) == 1 and want_ma[0].score >= 100
    # the rescued mate (reverse strand) ends past the narrow cut of the
    # window, which starts at a.rb + low - the mate's length
    fwd_end = 2 * idx.l_pac - want_ma[0].rb
    assert fwd_end - (a.rb + pes[1].low - ms.size) > NARROW.rescue_t
    assert [dataclasses.asdict(r) for r in got_ma] == \
        [dataclasses.asdict(r) for r in want_ma]
    assert timers.counters["pair.rescue_truncated"] == 0


# ------------------------------------------------------------------ (d) --

def test_short_reads_run_the_narrow_widths_and_equal_jax_se():
    from test_torch_flat import _aligners

    jal, tal, batch = _aligners("repeat", 64)
    assert batch.codes.shape[1] == 160
    with recorded_widths() as seen:
        got = tal.align_se_text(batch, 0)
    assert seen["L"] == {160}
    _same_bucket(seen, NARROW, pe=False)
    assert got == jal.align_se_text(batch, 0)


def test_short_pairs_run_the_narrow_widths_and_equal_jax_pe():
    from test_torch_pe import repeat_inputs

    from tpubwa.align.pair import align_pe_batch as jax_pe_batch
    from tpubwa.align.pipeline import Aligner as JaxAligner
    from tpubwa.config import MemOptions as JaxOptions
    from tpubwa_torch.align.pair import align_pe_batch
    from tpubwa_torch.align.pipeline import Aligner

    idx, b1, b2 = repeat_inputs()
    opt = JaxOptions(batch_reads=160, max_read_len=160)
    with recorded_widths() as seen:
        got = align_pe_batch(Aligner(idx, opt, device="cpu"), b1, b2, 0)
    assert seen["L"] == {160}
    _same_bucket(seen, NARROW, pe=True)
    assert got == jax_pe_batch(JaxAligner(idx, opt), b1, b2, 0)


# ------------------------------------------------------------------ (e) --

@pytest.mark.parametrize("others", [150, 250])
def test_a_read_past_256_is_unmapped_with_a_warning(genome, tmp_path,
                                                    others):
    from tpubwa_torch.align.pipeline import Aligner, run_se_pipeline

    _, idx, text = genome
    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = [lut[np.asarray(text[p:p + n])].tobytes().decode()
            for p, n in ((20_000, others), (30_000, LONG_READ_LEN + 1),
                         (40_000, others))]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(seqs)))
    al = Aligner(idx, OPT, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stderr(err):
        run_se_pipeline(al, str(fq), out)
    recs = [ln.split("\t") for ln in out.getvalue().splitlines()
            if not int(ln.split("\t")[1]) & 0x900]
    assert [r[0] for r in recs] == ["r0", "r1", "r2"]
    assert int(recs[1][1]) & 4 and recs[1][9] == seqs[1]
    assert f"read r1 length {LONG_READ_LEN + 1} > max read length " \
        f"{LONG_READ_LEN}; emitting it unmapped" in err.getvalue()
    for r, pos in ((recs[0], 20_001), (recs[2], 40_001)):
        assert not int(r[1]) & 4 and int(r[3]) == pos
    assert al.timers.counters["fastq.wide_batches"] == (others > 160)


# ------------------------------------------------------------------ (f) --

@pytest.fixture(scope="module")
def wide_pairs(genome, tmp_path_factory):
    """One batch of 250-bp pairs and its text through the normal path."""
    _, idx, text = genome
    paths = _fastqs(tmp_path_factory.mktemp("t_long_f"), text,
                    _traffic(2, 250), n_batches=1, stream=1)
    return paths, _align(idx, paths)[0]


@pytest.mark.parametrize("mode", ["mesh", "chunks", "threads"])
def test_serving_modes_follow_the_wide_bucket(genome, wide_pairs, tmp_path,
                                              mode):
    _, idx, _ = genome
    paths, want = wide_pairs
    kw = {"mesh": dict(device=["cpu"] * 2),
          "chunks": dict(chunk_dir=str(tmp_path / "ck")),
          "threads": dict(workers=2)}[mode]
    with recorded_widths() as seen:
        got, _ = _align(idx, paths, **kw)
    _same_bucket(seen, WIDE, pe=True)
    assert got == want
    if mode == "chunks":     # a second run takes the chunk files
        assert _align(idx, paths, **kw)[0] == want


def test_per_read_path_follows_the_wide_bucket(genome, wide_pairs):
    """The per-read chain-and-extend path on the wide read-1 batch gives
    the flat engine's regions, at the wide query window."""
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.io.fastq import stream_batches

    _, idx, _ = genome
    batch = next(stream_batches(wide_pairs[0][0], BATCH, OPT.max_read_len))
    assert batch.codes.shape[1] == LONG_READ_LEN
    al = Aligner(idx, OPT, device="cpu")
    flat = al.regions_batch(batch)
    rows, l_rep = al.seed_batch(batch.codes, batch.lens)
    chains = al.chain_batch(rows, l_rep, batch.lens)
    pads = []
    from tpubwa_torch.align import pipeline

    real = pipeline.run_extension_rounds

    def recording(gens, opt, extend_round, **kw):
        pads.append(kw["q_pad"])
        return real(gens, opt, extend_round, **kw)

    pipeline.run_extension_rounds = recording
    try:
        regs = al.extend_batch_rounds(batch.codes, batch.lens, chains)
    finally:
        pipeline.run_extension_rounds = real
    assert pads == [WIDE.ext_q]
    assert [[dataclasses.astuple(r) for r in rr] for rr in regs] == \
        [[dataclasses.astuple(r) for r in rr] for rr in flat]


def test_device_align_step_refuses_a_wide_batch(genome):
    from tpubwa_torch.ops.fm import DeviceIndex
    from tpubwa_torch.parallel.mesh import device_align_step

    _, idx, _ = genome
    di = DeviceIndex.from_host(idx, "cpu")
    codes = torch.full((4, LONG_READ_LEN), 4, dtype=torch.int32)
    lens = torch.full((4,), 200, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 160 bp"):
        device_align_step(di, codes, lens, torch.as_tensor(MAT))
    # the narrow bucket's batch runs
    out = device_align_step(di, codes[:, :160].contiguous(),
                            torch.full((4,), 150, dtype=torch.int32),
                            torch.as_tensor(MAT))
    assert out[4].shape == (4,)


def test_a_pair_of_batches_of_two_widths_runs_at_the_wider(genome,
                                                           tmp_path):
    """Read 1 at 150 bp, read 2 at 250: the pair runs in the wide bucket,
    read 1 padded to it, and gives what the two ends at one width give."""
    from tpubwa_torch.align.pair import align_pe_batch, same_width
    from tpubwa_torch.align.pipeline import Aligner
    from tpubwa_torch.io.fastq import stream_batches

    _, idx, text = genome
    p1 = _fastqs(tmp_path, text, _traffic(1, 150), n_batches=1, stream=2)
    t2 = tmp_path / "two"
    t2.mkdir()
    p2 = _fastqs(t2, text, _traffic(1, 250), n_batches=1, stream=3)
    b1 = next(stream_batches(p1[0], BATCH, 160))
    b2 = next(stream_batches(p2[0], BATCH, 160))
    assert (b1.codes.shape[1], b2.codes.shape[1]) == (160, LONG_READ_LEN)
    al = Aligner(idx, OPT, device="cpu")
    with recorded_widths() as seen:
        got = align_pe_batch(al, b1, b2, 0)
    _same_bucket(seen, WIDE, pe=True)
    w1, w2 = same_width(b1, b2)
    assert w1.codes.shape[1] == LONG_READ_LEN and w2 is b2
    assert align_pe_batch(al, copy.copy(w1), w2, 0) == got
    with pytest.raises(ValueError, match="differ in width"):
        align_pe_batch(al, b1, b2, 0, handles=(
            al.seed_batch_dispatch(b1.codes, b1.lens),
            al.seed_batch_dispatch(b2.codes, b2.lens)))
