"""The port's data-parallel layer (``repro_torch.parallel``) on the CPU.

In this process (no process group is opened here): padding, the mesh
policy and its refusals, compressor parsing, and the compression functions
bit for bit against the reference's (``repro.parallel.compression``) on the
same arrays (floats compared by their bits, :func:`repro_torch.tree.
bit_equal`: ``torch.equal`` and ``np.array_equal`` count -0.0 equal to
+0.0).

Across processes: ``tests/_torch_ranks.py`` spawns 2 or 4 ranks over gloo
(``file://`` init under ``tmp_path``, no TCP port), once per world size,
and every test below reads one part of what the ranks returned:

* ``ShardedEngine`` tables (grid through order 4, every operator's
  crosses, derivs) under ``ntp`` and ``ntp/cuda`` (the kernels' plain
  versions here) against the single-process call, at 19 and 3 rows.  Not
  bit for bit: on the CPU a row's arithmetic depends on the batch size
  (the BLAS picks another kernel for a stacked matmul of another row
  count; a single-process call on 10 of 20 rows already differs by ~2e-16),
  so the tables are held at 1e-13 of their largest |value|;
* the sharded Adam step against the reference's plain value_and_grad +
  Adam step (JAX, computed here) at 1e-12, and against the port's
  single-process step; the compressed steps descend; error feedback over
  the real reduce converges to the exact sum;
* ``pinn_loss(mesh=)`` and its gradient (the sharded L-BFGS objective's),
  on the DenseMLP and the Transformer trunk, at 1e-12;
* ``train_operator(data_parallel=N)`` and ``(mesh=)`` against the
  single-process run on every logged loss (Adam and L-BFGS) at 1e-12;
* ``DerivativeServer(mesh=)`` against direct engine calls;
* ``gather_rows_by_sum`` (the gather ``gather_rows`` runs for gloo on CUDA
  tensors) returns every rank's rows bit for bit, -0.0 entries included,
  where a float sum of the same buffers turns them into +0.0.

The ``multidevice`` test (deselected by default) runs the engine sweep at 3
ranks (pad rows on every shard) on the DenseMLP and the trunk, orders 2 and
4, and the training and serving checks there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R
from repro.parallel import compression as jcomp
from repro_torch.parallel import (DataMesh, ShardedEngine, compression as tcomp,
                                  pad_rows, resolve_mesh)
from repro_torch.parallel.jet_shard import _compressor
from repro_torch.core.engines import NTPEngine
from repro_torch.tree import bit_equal

TABLE_TOL = 1e-13    # batch-size dependence of the CPU BLAS, see the docstring
# the trunk's cross tables sum polarization terms that nearly cancel (zero
# embedding bias: near-singular at x_t = 0), which magnifies that last-ulp
# difference relative to the table's own max
TRUNK_TABLE_TOL = 1e-11
TOL = 1e-12
WORLD_SIZES = (2, 4)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_pad_rows_remainder_and_identity():
    x = torch.arange(14.0).reshape(7, 2)
    padded, n = pad_rows(x, 4)
    assert n == 7 and padded.shape == (8, 2)
    assert bit_equal(padded[:7], x) and bool((padded[7:] == 0).all())
    same, n2 = pad_rows(x, 7)
    assert same is x and n2 == 7
    with pytest.raises(ValueError, match="multiple"):
        pad_rows(x, 0)


def test_resolve_mesh_policy_and_refusals():
    assert resolve_mesh(None, 0) is None and resolve_mesh(None, None) is None
    for n in (1, 2, 4):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            resolve_mesh(None, n)
    with pytest.raises(ValueError, match=">= 1"):
        resolve_mesh(None, -1)
    bad = object()
    with pytest.raises(ValueError, match="'data' axis"):
        resolve_mesh(bad)
    with pytest.raises(ValueError, match="'data' axis"):
        ShardedEngine(NTPEngine(), bad)


def test_compressor_spec_parsing():
    assert _compressor(None) is None and _compressor("") is None
    assert _compressor("none") is None and _compressor("NONE") is None
    assert _compressor("int8") is tcomp.compressed_psum_tree
    assert callable(_compressor("topk:0.25"))
    with pytest.raises(ValueError, match="unknown grad compression"):
        _compressor("gzip")


def test_topk_mask_keeps_exactly_the_largest():
    mags = np.random.RandomState(0).permutation(np.arange(1.0, 101.0))
    g = torch.from_numpy(mags * np.where(np.arange(100) % 2, 1.0, -1.0))
    keep = tcomp.topk_mask(g, 0.1)
    assert int(keep.sum()) == 10
    assert float(g[keep].abs().min()) > float(g[~keep].abs().max())
    assert bool(tcomp.topk_mask(g, 1.0).all())
    assert int(tcomp.topk_mask(g, 1e-9).sum()) == 1
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="k_frac"):
            tcomp.topk_mask(g, bad)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compression_functions_bit_for_bit_against_the_reference(dtype):
    rng = np.random.default_rng(0)
    for shape, scale in (((96,), 3.0), ((7, 5), 1e-3), ((4, 4, 3), 50.0)):
        g = (rng.normal(size=shape) * scale).astype(dtype)
        # ties at .5 of a quantization step, to pin round half to even
        g.reshape(-1)[:4] = np.array([63.5, -63.5, 0.5, 2.5]) * (np.abs(g).max() / 127.0)
        err = (rng.normal(size=shape) * scale * 1e-2).astype(np.float32)
        tq, ts = tcomp.quantize_int8(torch.from_numpy(g))
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        assert np.array_equal(tq.numpy(), np.asarray(jq)) and float(ts) == float(js)
        assert bit_equal(tcomp.dequantize_int8(tq, ts),
                         torch.tensor(np.asarray(jcomp.dequantize_int8(jq, js))))
        terr = torch.from_numpy(err).to(torch.bfloat16)
        jerr = jnp.asarray(err).astype(jnp.bfloat16)
        tq, ts, tn = tcomp.ef_compress(torch.from_numpy(g), terr)
        jq, js, jn = jcomp.ef_compress(jnp.asarray(g), jerr)
        assert np.array_equal(tq.numpy(), np.asarray(jq)) and float(ts) == float(js)
        assert tn.dtype == torch.bfloat16
        assert bit_equal(tn.float(), torch.tensor(np.asarray(jn.astype(jnp.float32))))
        for frac in (0.05, 0.3, 1.0):
            assert np.array_equal(tcomp.topk_mask(torch.from_numpy(g), frac).numpy(),
                                  np.asarray(jcomp.topk_mask(jnp.asarray(g), frac)))
    tree = {"w": torch.zeros((3, 2)), "b": (torch.zeros(4, dtype=torch.float64),)}
    ef = tcomp.ef_init(tree)
    assert ef["w"].dtype == torch.bfloat16 and ef["b"][0].shape == (4,)
    assert all(float(t.abs().max()) == 0.0 for t in (ef["w"], ef["b"][0]))


def test_bit_equal_tells_signed_zeros_apart():
    """``torch.equal`` compares values: -0.0 == +0.0 passes it.  bit_equal
    compares the integer views, so it does not, at every float width, and
    it also checks dtype and shape, and trees leaf by leaf."""
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        neg, pos = torch.tensor([1.5, -0.0], dtype=dt), torch.tensor([1.5, 0.0], dtype=dt)
        assert torch.equal(neg, pos) and not bit_equal(neg, pos)
        assert bit_equal(neg, neg.clone())
    nan = torch.tensor([float("nan")])
    assert not torch.equal(nan, nan) and bit_equal(nan, nan.clone())
    x = torch.zeros(4)
    assert not bit_equal(x, x.double()) and not bit_equal(x, x.reshape(2, 2))
    assert bit_equal({"a": (x, x[:2])}, {"a": (x.clone(), x[:2].clone())})
    assert not bit_equal((x,), (x, x))


# ---------------------------------------------------------------------------
# across processes: one spawn per world size, many checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda n: f"ranks{n}")
def ranks(request, tmp_path_factory):
    n = request.param
    return n, R.spawn(n, "everything", tmp_path_factory.mktemp(f"ranks{n}"), timeout=600)


def test_sharded_tables_match_the_single_process_call(ranks):
    n, res = ranks
    for r in range(n):                      # every rank holds the whole table
        for key, rel in res[r]["engine"].items():
            assert rel <= TABLE_TOL, (r, key, rel)


def _reference_adam(steps=4, lr=1e-2):
    """The reference's plain loop: jax.value_and_grad + repro.optim's Adam
    on the toy problem of tests/test_jet_shard.py, on the same numbers."""
    from repro.optim import adam_init, adam_update
    tp, tpts = R.toy_problem()
    params = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    pts = jnp.asarray(tpts.numpy())

    def loss(p, x):
        pred = x @ p["w"] + p["b"]
        return jnp.mean((pred - jnp.sin(x[:, :1])) ** 2)

    state, losses = adam_init(params), []
    for _ in range(steps):
        value, grads = jax.value_and_grad(loss)(params, pts)
        params, state = adam_update(grads, state, params, lr)
        losses.append(float(value))
    return params, losses


def test_sharded_adam_step_matches_the_reference_plain_step(ranks):
    n, res = ranks
    ref_params, ref_losses = _reference_adam()
    for r in range(n):
        adam = res[r]["training"]["adam"]
        for k, v in ref_params.items():
            np.testing.assert_allclose(adam["params"][k].numpy(), np.asarray(v),
                                       rtol=TOL, atol=0)
            np.testing.assert_allclose(adam["single"][k].numpy(), np.asarray(v),
                                       rtol=TOL, atol=0)
        np.testing.assert_allclose([a for a, _ in adam["losses"]], ref_losses, rtol=TOL)
        np.testing.assert_allclose(adam["aux"], [a for a, _ in adam["losses"]], rtol=TOL)
        assert adam["err_max"] == 0.0      # the exact sum leaves the EF state alone
    assert "does not divide" in res[0]["training"]["indivisible_batch"]
    assert f"has {n} ranks" in res[0]["training"]["wrong_world_size"]


@pytest.mark.parametrize("spec", ["int8", "topk:0.5"])
def test_compressed_steps_descend(ranks, spec):
    _, res = ranks
    hist = res[0]["training"][f"descent/{spec}"]
    assert all(math.isfinite(v) for v in hist) and hist[-1] < 0.5 * hist[0], hist


@pytest.mark.parametrize("spec,tol", [("int8", 0.01), ("topk:0.2", 0.05)])
def test_error_feedback_accumulation_is_unbiased(ranks, spec, tol):
    """sum_t compressed(g) / T -> the exact sum over the ranks (tolerances
    of the reference's tests/test_jet_shard.py)."""
    n, res = ranks
    for r in range(n):
        assert res[r]["training"][f"ef/{spec}"] < tol


@pytest.mark.parametrize("network", ["dense", "transformer"])
def test_pinn_loss_mesh_and_its_gradient(ranks, network):
    """pinn_loss(mesh=) is the sharded L-BFGS objective: the same loss and
    the whole batch's gradient on every rank."""
    n, res = ranks
    for r in range(n):
        got = res[r]["training"][f"pinn_loss/{network}"]
        np.testing.assert_allclose(*got["loss"], rtol=TOL)
        for sharded, single in got["aux"].values():
            np.testing.assert_allclose(sharded, single, rtol=TOL)
        assert got["grad_rel"] <= TOL, got["grad_rel"]


def test_train_operator_data_parallel_matches_the_single_process_run(ranks):
    n, res = ranks
    for r in range(n):
        t = res[r]["training"]["train"]
        assert len(t["single"]) == 6 + 3        # 6 logged Adam steps, L-BFGS history
        np.testing.assert_allclose(t["sharded"], t["single"], rtol=TOL)
        np.testing.assert_allclose(t["mesh"], t["single"], rtol=TOL)
        assert t["params_rel"] <= TOL
        np.testing.assert_allclose(*t["l2"], rtol=1e-10)
        hist = res[r]["training"]["train_int8"]
        assert all(math.isfinite(v) for v in hist) and hist[-1] < hist[0]
        assert "does not divide" in res[r]["training"]["indivisible_n_domain"]


def test_sharded_server_matches_direct_engine_calls(ranks):
    n, res = ranks
    srv = res[0]["serving"]
    for kind in ("dense", "transformer"):
        for what, rel in srv[kind].items():
            assert rel <= TABLE_TOL, (kind, what, rel)
    assert srv["mesh_key"] == (("data", n),)
    assert srv["cache_keys"] and all(k == (("data", n),) for k in srv["cache_keys"])
    for r in range(n):
        assert "do not divide" in res[r]["serving"]["bucket_guard"]
    for r in range(1, n):
        assert "submit them on rank 0" in res[r]["serving"]["follower_submit"]


def test_integer_sum_gather_keeps_signed_zeros(ranks):
    n, res = ranks
    for r in range(n):
        for dtype, got in res[r]["gather"].items():
            assert got["by_sum_bits"], (r, dtype)
            # the float sum the gather ran before: equal by value, not by bits
            assert got["float_sum_equal"] and not got["float_sum_bits"], (r, dtype)


def test_sharded_server_outlives_an_idle_gap_longer_than_the_group_timeout(tmp_path):
    """The other ranks wait for rank 0's next header in a collective; an
    idle gap longer than the group's timeout must not end their loops."""
    res = R.spawn(2, "serving_idle", tmp_path, timeout=300)
    assert res[0] == {"equal": True, "batches": 2}


@pytest.mark.multidevice
def test_three_ranks_every_operator_dense_and_trunk(tmp_path):
    """The heavier sweep: 3 ranks (19 rows pad to 21, 3 rows one a shard),
    the DenseMLP and the Transformer trunk, grid orders 2 and 4, every
    operator, plus the training and serving checks."""
    res = R.spawn(3, "everything", tmp_path, timeout=1200,
                  networks=("dense", "transformer"), orders=(2, 4))
    ref_params, _ = _reference_adam()
    for r in range(3):
        for key, rel in res[r]["engine"].items():
            tol = TRUNK_TABLE_TOL if key.endswith("transformer") else TABLE_TOL
            assert rel <= tol, (r, key, rel)
        t = res[r]["training"]
        np.testing.assert_allclose(t["train"]["sharded"], t["train"]["single"], rtol=TOL)
        for k, v in ref_params.items():
            np.testing.assert_allclose(t["adam"]["params"][k].numpy(), np.asarray(v),
                                       rtol=TOL, atol=0)
    for kind in ("dense", "transformer"):
        assert all(rel <= TABLE_TOL for rel in res[0]["serving"][kind].values())
