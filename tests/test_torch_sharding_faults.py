"""Two layouts of the port's sharded LM path that depended on the torch
version, held on four gloo ranks of a (1, 4) ("data", "model") mesh
(``tests/_torch_ranks.py``'s ``sharding_faults``), float64:

* ``sharding_rules.dense`` of a row-sharded weight: an activation that
  reaches it replicated (as mamba's normed ``out_proj`` input did on torch
  2.11) must make a row-parallel product -- each rank contracts its K / 4
  slice, the output is partial and nothing is gathered -- as one already
  split along K does;
* llama4's MoE layer with its experts split over "model" (expert
  parallel): each rank packs only its own experts' dispatch buffer and
  contributes its share of the combine's sum, and the layer's output and
  gradients equal the unsharded layer's.

The dry run's cells at the production meshes are in
``tests/test_torch_dryrun.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R

WORLD = 4
TOL = 1e-12


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.spawn(WORLD, "sharding_faults", tmp_path_factory.mktemp("sharding_faults"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("x_layout", ["replicated", "split"])
def test_dense_row_sharded_weight_is_row_parallel(runs, x_layout):
    """Whether ``x`` arrives replicated or split along K: the output is
    partial over "model", each rank's product contracts K / 4, no
    collective moves ``x`` or the weight, and the result is ``x @ w``."""
    for out in runs:
        case = out[x_layout]
        assert case["placements"] == "(Replicate(), Partial(sum))"
        assert case["k"] == [4], case["k"]
        assert case["collectives"] == {}, case["collectives"]
        assert _rel(case["y"], out["want"]) <= TOL


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_expert_parallel_moe_matches_unsharded(runs, mode):
    """The layer's output, balance loss and the gradients of every
    parameter and of its input, expert parallel against unsharded."""
    for out in runs:
        case = out[f"moe_{mode}"]
        plain, sharded = case["plain"], case["sharded"]
        assert _rel(sharded["y"], plain["y"]) <= TOL
        assert _rel(sharded["aux"], plain["aux"]) <= TOL
        assert len(sharded["grads"]) == len(plain["grads"]) == 4
        for got, want in zip(sharded["grads"], plain["grads"]):  # x, router, wi, wo
            assert _rel(got, want) <= TOL


def test_expert_parallel_dispatch_packs_its_own_experts(runs):
    """Each rank's dispatch buffer holds its 4 of the 16 experts; the
    unsharded layer's holds all 16."""
    for out in runs:
        buffers = out["moe_buffers"]
        assert len(buffers) == 4            # plain and sharded, inference and training
        assert [b[1] for b in buffers] == [16, 4, 16, 4], buffers
