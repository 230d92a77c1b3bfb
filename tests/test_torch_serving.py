"""The port's serving subsystem on the CPU: ``DerivativeServer(device="cpu")``.

Served tables equal the port's direct engine call (rtol 1e-13: same
arithmetic, the padded launch only adds independent rows) and the JAX
engine's table (1e-12); bucketing, padding and slicing; coalescing of
concurrent clients; the typed errors; the cache counters; and serving a
checkpoint written by the JAX package's CheckpointManager."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointManager
from repro.core.engines import NTPEngine as JNTP
from repro.core.network import make_network as jmake
from repro.runtime import metrics as jmetrics
from repro_torch import bridge
from repro_torch.core.engines import DerivativeEngine
from repro_torch.core.network import make_network
from repro_torch.runtime import metrics as tmetrics
from repro_torch.serving import (DerivativeServer, ExecutableCache,
                                 ExecutableKey, RequestTimeoutError,
                                 RequestTooLargeError, ServerClosedError,
                                 ServerOverloadedError, pad_fraction, pad_to,
                                 pick_bucket)
from repro_torch.tree import bit_equal

KW = dict(d_in=2, d_out=1, width=8, depth=2)


@pytest.fixture(scope="module")
def model():
    jnet = jmake("dense", **KW)
    jp = jnet.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jnet, jp, make_network("dense", **KW), tp


@pytest.fixture(scope="module")
def xs():
    rng = np.random.default_rng(1)
    return {n: torch.tensor(rng.uniform(-1, 1, size=(n, 2))) for n in (3, 5, 8, 11)}


@pytest.fixture(scope="module")
def jax_grid(model, xs):
    """The JAX engine's order-4 grid on xs[5], per impl, jitted; a grid of
    order k is its first k+1 orders."""
    jnet, jp, _, _ = model
    cache = {}

    def table(jimpl, order):
        if jimpl not in cache:
            grid = jax.jit(lambda p, x: JNTP(jimpl).grid(jnet, p, x, 4))
            cache[jimpl] = np.asarray(grid(jp, jnp.asarray(xs[5].numpy())))
        return cache[jimpl][:, :order + 1]
    return table


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-300))


# ---------------------------------------------------------------------------
# bucketing and cache
# ---------------------------------------------------------------------------

def test_pick_bucket_smallest_admissible_and_typed_errors():
    assert pick_bucket(1, (8, 16, 32)) == 8
    assert pick_bucket(8, (8, 16, 32)) == 8
    assert pick_bucket(9, (32, 8, 16)) == 16
    with pytest.raises(RequestTooLargeError):
        pick_bucket(33, (8, 16, 32))
    with pytest.raises(ValueError):
        pick_bucket(0, (8, 16))


def test_pad_to_zero_rows_and_identity(xs):
    x5 = xs[5]
    padded = pad_to(x5, 8)
    assert padded.shape == (8, 2)
    assert torch.equal(padded[:5], x5) and not padded[5:].any()
    assert pad_to(x5, 5) is x5
    with pytest.raises(ValueError):
        pad_to(x5, 4)
    assert pad_fraction(5, 8) == pytest.approx(3 / 8)


def test_cache_lru_eviction_and_counters():
    cache = ExecutableCache(capacity=2)
    keys = [ExecutableKey("n", "ntp", "grid", (o,), 8, "torch.float64")
            for o in range(3)]
    for k in keys:
        cache.get_or_build(k, lambda: object())
    assert cache.stats()["evictions"] == 1 and keys[0] not in cache
    _, hit = cache.get_or_build(keys[2], lambda: object())
    assert hit and cache.stats() == {"hits": 1, "misses": 3, "evictions": 1,
                                     "size": 2, "capacity": 2}
    with pytest.raises(ValueError):
        ExecutableCache(capacity=0)


def test_metrics_match_reference_quantiles():
    samples = list(np.random.default_rng(2).exponential(size=50))
    for q in (50, 99):
        assert tmetrics.percentile(samples, q) == jmetrics.percentile(samples, q)
    stats = tmetrics.LatencyStats(window=10)
    for s in samples:
        stats.record(s)
    snap = stats.snapshot()
    assert snap["count"] == 50 and snap["p50_us"] == pytest.approx(
        jmetrics.percentile(samples[-10:], 50) * 1e6)
    assert tmetrics.percentile([], 50) == 0.0


# ---------------------------------------------------------------------------
# served tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["ntp", "ntp/cuda", "autodiff"])
@pytest.mark.parametrize("order", [0, 2, 4])
def test_served_grid_matches_direct_and_jax(model, xs, jax_grid, engine, order):
    _, _, net, p = model
    x = xs[5]
    with DerivativeServer(net, p, engine, buckets=(8, 16), device="cpu") as srv:
        res = srv.submit(x, order=order).result(timeout=60)
    direct = DerivativeEngine.from_spec(engine).grid(net, p, x, order)
    assert res.table.shape == (2, order + 1, 5, 1) and res.bucket == 8
    assert res.pad_fraction == pytest.approx(3 / 8)
    _close(res.table, direct, 1e-13)
    jimpl = "pallas" if engine == "ntp/cuda" else "jnp"
    _close(res.table, jax_grid(jimpl, order), 1e-12)


@pytest.mark.parametrize("axes", [(0, 1), (0, 0, 1, 1)])
def test_served_cross_matches_direct_and_jax(model, xs, axes):
    jnet, jp, net, p = model
    x = xs[11]
    with DerivativeServer(net, p, "ntp/cuda", buckets=(8, 16), device="cpu") as srv:
        table = srv.cross(x, axes, timeout=60)
    _close(table, DerivativeEngine.from_spec("ntp/cuda").cross(net, p, x, axes), 1e-13)
    jcross = jax.jit(lambda q, xx: JNTP("jnp").cross(jnet, q, xx, axes))
    _close(table, jcross(jp, jnp.asarray(x.numpy())), 1e-12)


def test_concurrent_clients_coalesce_into_one_launch(model, xs):
    _, _, net, p = model
    srv = DerivativeServer(net, p, "ntp", buckets=(8, 16, 32), device="cpu",
                           autostart=False)
    futs = [srv.submit(xs[n], order=2) for n in (3, 5, 8)]
    other = srv.submit(xs[3], axes=(0, 1))      # another group: stays queued
    assert srv._drain_once()
    results = [f.result(timeout=0) for f in futs]
    assert {r.batch_rows for r in results} == {16} and results[0].bucket == 16
    assert not other.done() and srv.metrics()["queue_depth"] == 1
    for n, r in zip((3, 5, 8), results):
        _close(r.table, DerivativeEngine.from_spec("ntp").grid(net, p, xs[n], 2), 1e-13)
    assert srv._drain_once() and other.done()
    srv.close()


def test_threaded_clients_get_their_own_rows(model, xs):
    _, _, net, p = model
    out, errors = {}, []

    def client(n):
        try:
            out[n] = srv.grid(xs[n], 3, timeout=60)
        except Exception as e:              # noqa: BLE001 -- asserted below
            errors.append(e)

    with DerivativeServer(net, p, "ntp/cuda", buckets=(8, 32), device="cpu",
                          flush_window_s=0.05) as srv:
        threads = [threading.Thread(target=client, args=(n,)) for n in (3, 5, 8, 11)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        m = srv.metrics()
    assert not errors
    assert m["requests"] == 4 and m["batches"] <= 4
    for n, table in out.items():
        _close(table, DerivativeEngine.from_spec("ntp").grid(net, p, xs[n], 3), 1e-13)


def test_cache_hits_and_misses_and_canonical_spec(model, xs):
    _, _, net, p = model
    with DerivativeServer(net, p, "ntp/torch", buckets=(8, 16), device="cpu") as srv:
        assert srv.engine_spec == "ntp"
        hits = [srv.submit(xs[n], order=1).result(timeout=60).cache_hit
                for n in (3, 5, 11, 8)]
        stats = srv.metrics()["cache"]
        lat = srv.metrics()["latency"]
    assert hits == [False, True, False, True]
    assert stats["hits"] == 2 and stats["misses"] == 2 and stats["size"] == 2
    assert lat["count"] == 4 and lat["p99_us"] >= lat["p50_us"] > 0


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

def test_overload_timeout_too_large_and_closed(model, xs):
    _, _, net, p = model
    srv = DerivativeServer(net, p, "ntp", buckets=(8,), max_queue=1,
                           device="cpu", autostart=False)
    with pytest.raises(RequestTooLargeError):
        srv.submit(xs[11], order=1)
    with pytest.raises(ValueError):
        srv.submit(xs[3], order=1, axes=(0,))
    with pytest.raises(ValueError):
        srv.submit(torch.zeros((3, 3), dtype=torch.float64), order=1)
    with pytest.raises(RequestTimeoutError):
        srv.grid(xs[3], 1, timeout=0.01)        # queued, worker not running
    with pytest.raises(ServerOverloadedError):
        srv.submit(xs[5], order=1)
    pending = srv._q[0].future
    srv.close()
    with pytest.raises(ServerClosedError):
        pending.result(timeout=0)
    with pytest.raises(ServerClosedError):
        srv.submit(xs[3], order=1)


def test_failed_launch_fails_only_its_requests(model, xs, monkeypatch):
    """A launch that raises (here every order-9 dense launch, refused as a
    block that does not fit would be) fails its own requests; the server
    goes on answering the next ones."""
    from repro_torch.kernels import ops as tops
    _, _, net, p = model
    real = tops._jet_dense_impl

    def refusing(coeffs, w, b, activation):
        if coeffs.shape[0] == 10:
            raise ValueError("the jet_dense kernel needs more shared memory than a block has")
        return real(coeffs, w, b, activation)

    monkeypatch.setattr(tops, "_jet_dense_impl", refusing)
    with DerivativeServer(net, p, "ntp/cuda", buckets=(8,), device="cpu") as srv:
        with pytest.raises(ValueError, match="shared memory"):
            srv.grid(xs[3], 9, timeout=60)
        assert srv.grid(xs[3], 2, timeout=60).shape == (2, 3, 3, 1)


# ---------------------------------------------------------------------------
# checkpoints written by the JAX package
# ---------------------------------------------------------------------------

def test_from_checkpoint_serves_the_jax_tables(model, xs, tmp_path):
    jnet, jp, net, _ = model
    CheckpointManager(str(tmp_path)).save(7, jp)
    x = xs[8]
    with DerivativeServer.from_checkpoint(str(tmp_path), net, engine="ntp/cuda",
                                          buckets=(8,), device="cpu") as srv:
        assert all(t.dtype == torch.float64 for t in srv.params)
        table = srv.grid(x, 4, timeout=60)
        cross = srv.cross(x, (0, 0, 1, 1), timeout=60)
    xj = jnp.asarray(x.numpy())
    jgrid = jax.jit(lambda q, xx: JNTP("jnp").grid(jnet, q, xx, 4))
    jcross = jax.jit(lambda q, xx: JNTP("jnp").cross(jnet, q, xx, (0, 0, 1, 1)))
    _close(table, jgrid(jp, xj), 1e-12)
    _close(cross, jcross(jp, xj), 1e-12)


def test_load_jax_checkpoint_for_mlp_and_mismatch(tmp_path):
    jnet = jmake("mlp", d_in=2, d_out=1, width=4, depth=2)
    jp = jnet.init(jax.random.PRNGKey(5), dtype=jnp.float64)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, jp)
    mgr.save(2, jax.tree_util.tree_map(lambda a: a + 1.0, jp))
    tnet = make_network("mlp", d_in=2, d_out=1, width=4, depth=2)
    latest = bridge.load_jax_checkpoint(str(tmp_path), tnet, device="cpu")
    first = bridge.load_jax_checkpoint(str(tmp_path), tnet, step=1, device="cpu")
    for (tw, tb), (jw, jb) in zip(first, jp):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(latest[0][0].numpy(), np.asarray(jp[0][0]) + 1.0)
    with pytest.raises(ValueError, match="missing"):
        bridge.load_jax_checkpoint(str(tmp_path), make_network(
            "mlp", d_in=2, d_out=1, width=4, depth=3), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        bridge.load_jax_checkpoint(str(empty), tnet, device="cpu")


def test_bridge_roundtrip_both_directions(model):
    jnet, jp, net, tp = model
    back = bridge.params_to_numpy(tp)
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = bridge.params_from_numpy(back, device="cpu")
    assert type(again).__name__ == "MLPParams"
    assert bit_equal(again, tp)
    f32 = bridge.params_from_numpy(back, dtype=torch.float32, device="cpu")
    assert all(t.dtype == torch.float32 for t in f32)
