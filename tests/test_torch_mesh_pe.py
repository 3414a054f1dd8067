"""The paired-end leg of ``__graft_entry__.dryrun_multichip`` through the
port on a mesh of CPU shards at N = 2 and 4 (both ends' seeding and the
extension waves split over the shards; mate rescue and the SAM's CIGAR
program on the first device), and on the wide layout with the SA sharded:
each SAM is byte-identical to the JAX package's one-device SAM, which the
port's one device equals too."""
import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mesh import (force_wide_sharded,  # noqa: E402
                             repeat_genome_fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dryrun():
    from tpubwa.align.pair import align_pe_batch
    from tpubwa.align.pipeline import Aligner as JaxAligner

    d = repeat_genome_fixture()
    d["want"] = align_pe_batch(JaxAligner(d["idx"], d["opt"]), d["b1"],
                               d["b2"], 0)
    return d


@pytest.mark.parametrize("device,leg", [
    ("cpu", "pe"), (["cpu"] * 2, "pe"), (["cpu"] * 4, "pe"),
    (["cpu"] * 3, "wide")], ids=["one", "mesh-2", "mesh-4", "wide-sharded-3"])
def test_pe_leg(dryrun, device, leg):
    from tpubwa_torch.align.pair import align_pe_batch
    from tpubwa_torch.align.pipeline import Aligner

    opt = dataclasses.replace(dryrun["opt"], shard_sa=leg == "wide")
    al = Aligner(dryrun["idx"], opt, device=device)
    if leg == "wide":
        force_wide_sharded(al)
    assert align_pe_batch(al, dryrun["b1"], dryrun["b2"], 0) \
        == dryrun["want"]
