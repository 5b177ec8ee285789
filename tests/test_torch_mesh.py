"""The port's mesh and launcher (``parallel/mesh.py``, ``parallel/launch.py``)
against the JAX package's ``make_mesh`` on its 8-device CPU mesh: the
same axis names in the same order, the same position for each device /
rank; worlds that do not fit raise; a rank program imports no JAX.

The port's side runs in gloo worlds on the CPU started by ``run_ranks``;
the rank programs are in ``tests/torch_ranks.py``."""

import jax
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rag_challenge_2_tpu_torch.parallel import launch, make_mesh
from tests import torch_ranks

AXES = [{"slice": 2, "device": 4}, {"slice": 4, "device": 2}, {"data": 8}]


@pytest.fixture(scope="module")
def layouts():
    return launch.run_ranks(torch_ranks.mesh_layout, 8, "gloo", "cpu", (AXES,))


@pytest.mark.parametrize("case", range(len(AXES)))
def test_axis_names_order_and_positions_match_jax(layouts, case):
    axes = AXES[case]
    jm = jax_make_mesh(axes, devices=jax.devices("cpu"))
    assert tuple(jm.axis_names) == tuple(axes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, names, local, flat in layouts[case]:
        assert names == tuple(axes)
        # rank r sits where JAX puts the r-th device
        assert tuple(int(i) for i in np.argwhere(ids == rank)[0]) == local
        assert flat == rank          # P((a, b)) orders shards row-major


def test_meshes_that_do_not_fit_the_world_raise():
    errs = launch.run_ranks(torch_ranks.mesh_errors, 2, "gloo", "cpu")
    assert "needs 4 ranks, the world has 2" in errs["size"]
    assert "the world runs 'gloo'" in errs["backend"]
    assert "device type 'cpu'" in errs["device"]
    with pytest.raises(RuntimeError, match="running world"):
        make_mesh({"data": 1})


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    with pytest.raises(ValueError, match="card"):
        launch.run_ranks(torch_ranks.no_jax, 1, "nccl", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks, 1 card"):
        launch.check_world(2, "nccl", "cuda")


@pytest.mark.parametrize("backend,device,rank,want", [
    ("nccl", "cuda", 3, "cuda:3"), ("gloo", "cuda", 3, "cuda:0"),
    ("gloo", "cuda:1", 2, "cuda:1"), ("gloo", "cpu", 5, "cpu")])
def test_each_rank_computes_on_the_stated_device(backend, device, rank, want):
    assert launch.rank_device(rank, backend, device) == torch.device(want)


def test_a_rank_imports_no_jax():
    every = launch.run_ranks(torch_ranks.no_jax, 2, "gloo", "cpu")
    assert [mods for mods, _, _ in every] == [[], []]
    assert every[0][1] == every[1][1]          # the merged result is replicated


def test_a_failing_rank_ends_the_world():
    with pytest.raises(RuntimeError) as err:
        launch.run_ranks(torch_ranks.fail_on_rank, 3, "gloo", "cpu", (1,), timeout=120)
    assert "rank 1 of 3 failed" in str(err.value)
    assert "planted failure on rank 1" in str(err.value)
