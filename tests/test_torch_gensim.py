"""The port's realistic genome generator (``tpubwa_torch.utils.gensim``)
against the JAX package's (``tpubwa.utils.gensim``), bit for bit.

For each length, with and without N-islands, and at FASTA widths 80 and
60: ``repeat_genome``, ``realistic_genome`` (codes and ``n_mask``) and the
bytes ``write_fasta`` writes are equal, and the port's ``read_fasta`` of
that file gives the N-islands back as its holes.

``repeat_genome`` makes 8 segments of ``ref_len // 8`` bases, so at a
length that is not a multiple of 8 the JAX ``realistic_genome`` holds a
backbone ``ref_len % 8`` bases short: it fails at ``codes[n_mask] = 0``
with N-islands and returns codes shorter than ``n_mask`` without.  The
port pads the backbone with A's; at such a length it is held to the JAX
function run on the padded backbone (``repeat_genome`` replaced for the
call), and the failure of the unpatched JAX function is asserted.
"""
import numpy as np
import pytest

import tpubwa.utils.gensim as jgensim
from tpubwa_torch.io.fasta import read_fasta
from tpubwa_torch.utils import gensim, simgenome


def _runs(mask: np.ndarray) -> np.ndarray:
    """[start, end) runs of True in `mask`."""
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return np.stack([np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]], 1)


@pytest.mark.parametrize("width", [80, 60])
@pytest.mark.parametrize("islands", [True, False], ids=["islands", "no-n"])
@pytest.mark.parametrize("ref_len", [300_000, 1_000_003])
def test_gensim_equals_jax(tmp_path, monkeypatch, ref_len, islands, width):
    # utils.simgenome's function, not a second copy, equal to the JAX one
    assert gensim.repeat_genome is simgenome.repeat_genome
    rep = gensim.repeat_genome(np.random.default_rng(3), ref_len)
    np.testing.assert_array_equal(
        rep, jgensim.repeat_genome(np.random.default_rng(3), ref_len))
    assert rep.size == ref_len - ref_len % 8

    codes, n_mask = gensim.realistic_genome(np.random.default_rng(1234),
                                            ref_len, with_n_islands=islands)
    assert codes.dtype == np.uint8 and codes.shape == (ref_len,)
    assert n_mask.shape == (ref_len,) and n_mask.any() == islands
    if ref_len % 8:
        if islands:
            with pytest.raises(IndexError):
                jgensim.realistic_genome(np.random.default_rng(1234),
                                         ref_len)
        else:
            short, _ = jgensim.realistic_genome(np.random.default_rng(1234),
                                                ref_len,
                                                with_n_islands=False)
            assert short.size == rep.size
        wrapped = jgensim.repeat_genome
        monkeypatch.setattr(jgensim, "repeat_genome",
                            lambda rng, n: np.concatenate(
                                [wrapped(rng, n),
                                 np.zeros(n % 8, np.uint8)]))
    jcodes, jmask = jgensim.realistic_genome(np.random.default_rng(1234),
                                             ref_len, with_n_islands=islands)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(n_mask, jmask)

    mine, theirs = tmp_path / "t.fa", tmp_path / "j.fa"
    gensim.write_fasta(str(mine), codes, n_mask, name="bigsynth",
                       width=width)
    jgensim.write_fasta(str(theirs), jcodes, jmask, name="bigsynth",
                        width=width)
    assert mine.read_bytes() == theirs.read_bytes()
    contigs, got, holes = read_fasta(str(mine))
    assert [(c.name, c.length) for c in contigs] == [("bigsynth", ref_len)]
    np.testing.assert_array_equal(holes.reshape(-1, 2), _runs(n_mask))
    np.testing.assert_array_equal(got[~n_mask], codes[~n_mask])
