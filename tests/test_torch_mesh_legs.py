"""The single-end legs of ``__graft_entry__.dryrun_multichip`` through the
port on a mesh of CPU shards: plain, sharded SA, and the wide (int64)
layout with the SA sharded (the GRCh38 serving mode), at N = 2 and 4, on
its 100 kb repeat genome.  Each SAM is byte-identical to the JAX
package's one-device SAM, which the port's one device equals too.  (The
PE leg is ``test_torch_mesh_pe.py``.)"""
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
    from tpubwa.align.pipeline import Aligner as JaxAligner

    d = repeat_genome_fixture()
    d["want"] = JaxAligner(d["idx"], d["opt"]).align_se_text(d["batch"], 0)
    return d


def _aligner(d, device, leg):
    from tpubwa_torch.align.pipeline import Aligner

    opt = dataclasses.replace(d["opt"], shard_sa=leg != "se")
    al = Aligner(d["idx"], opt, device=device)
    if leg == "wide":
        force_wide_sharded(al)
    return al


def test_one_device_matches_jax(dryrun):
    al = _aligner(dryrun, "cpu", "se")
    assert al.align_se_text(dryrun["batch"], 0) == dryrun["want"]


@pytest.mark.parametrize("leg", ["se", "sharded", "wide"])
@pytest.mark.parametrize("n", [2, 4])
def test_leg_on_cpu_mesh(dryrun, n, leg):
    al = _aligner(dryrun, ["cpu"] * n, leg)
    assert len(al.mesh) == n
    assert al.align_se_text(dryrun["batch"], 0) == dryrun["want"]
    if leg != "se":
        assert al.di.sa.shape == (1,) and len(al.ssa.shards) == n
        assert al.ssa.shards[0].dtype == (torch.int64 if leg == "wide"
                                          else torch.int32)
