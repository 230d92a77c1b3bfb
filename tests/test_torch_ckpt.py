"""The port's checkpoint manager (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``): one on-disk format, read both ways.

Trees: the DenseMLP, Transformer trunk, ResidualMLP and FourierFeatureMLP
parameter trees (made by the reference's ``init``, carried over through
``repro_torch.bridge``) and a ``(params, AdamState)`` training state, at
float32 and float64.  A checkpoint the port writes is restored by the
reference's manager; one the reference writes is restored by the port's
manager and served by ``DerivativeServer.from_checkpoint``.  Every leaf is
compared by key through its integer view (dtype and bits), and the
manifest's leaves are the port's ``leaf_keys`` and the reference
``_flatten``'s keys, letter for letter.  bfloat16 goes through the port's
widening rule: written as float32, cast back through ``like``; the
reference's bfloat16 records (``|V2``) are read as their bits.

Also: restore errors naming the missing and extra leaves, and the sweep of
stale ``step_<N>.tmp`` directories.  The reference's inits are computed
once per file (``_once``).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointManager as JManager
from repro.ckpt.manager import _flatten as jflatten
from repro.core.network import make_network as jmake
from repro.optim import adam_init as jadam_init
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.network import make_network
from repro_torch.core.ntp import MLPParams
from repro_torch.optim import AdamState
from repro_torch.serving import DerivativeServer

NETS = {"dense": {}, "transformer": {"n_heads": 2, "mlp_ratio": 2}, "residual": {},
        "fourier": {"n_features": 4}}
KW = dict(d_in=2, d_out=1, width=8, depth=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TREES = tuple(NETS) + ("train_state",)
INT_VIEWS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

_REFERENCE = {}


def _once(key, fn):
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


def _reference_tree(kind: str, dtype: str):
    """The reference's tree of ``kind`` at ``dtype``: a network's parameters,
    or ``(params, AdamState)`` of the DenseMLP with moments off zero and a
    step count, so every leaf holds bits worth comparing."""
    jdt = DTYPES[dtype][0]

    def make():
        if kind != "train_state":
            return jmake(kind, **KW, **NETS[kind]).init(jax.random.PRNGKey(0), dtype=jdt)
        jp = jmake("dense", **KW).init(jax.random.PRNGKey(1), dtype=jdt)
        st = jadam_init(jp)._replace(
            step=jnp.asarray(7, jnp.int32),
            m=jax.tree_util.tree_map(lambda a: (a * 0.5).astype(jdt), jp),
            v=jax.tree_util.tree_map(lambda a: (a * a).astype(jdt), jp))
        return jp, st

    return _once((kind, dtype), make)


def _leaf_to_port(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port(jtree):
    """The reference tree as the port's (its NamedTuples the port's own)."""
    if isinstance(jtree, tuple) and len(jtree) == 2 and hasattr(jtree[1], "step"):
        params, st = jtree
        return (_port(params), AdamState(_leaf_to_port(st.step), _port(st.m), _port(st.v)))
    out = bridge.tree_map(lambda _, a: _leaf_to_port(a),
                          jax.tree_util.tree_map(np.asarray, jtree))
    return MLPParams(*out) if hasattr(out, "w_in") else out


def _bits(leaf):
    """(dtype name, integer view) of a tensor, a numpy or a JAX array."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1], leaf.view(INT_VIEWS[leaf.element_size()]).numpy()
    a = np.asarray(leaf)
    return a.dtype.name, a.view(np.dtype(f"i{a.itemsize}"))


def _assert_same_bits(port_tree, jax_tree):
    """Every leaf of the two trees, by checkpoint key: same dtype, shape
    and integer view; the key sets letter for letter."""
    got, want = bridge.by_key(port_tree), jflatten(jax_tree)
    assert set(got) == set(want)
    for key, leaf in got.items():
        (gd, gb), (wd, wb) = _bits(leaf), _bits(want[key])
        assert gd == wd and gb.shape == wb.shape and np.array_equal(gb, wb), key


def _zeros_like_port(tree):
    return bridge.tree_map(lambda _, t: torch.zeros_like(t), tree)


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", TREES)
def test_port_writes_the_reference_restores(kind, dtype, tmp_path):
    jtree = _reference_tree(kind, dtype)
    ttree = _port(jtree)
    CheckpointManager(str(tmp_path)).save(3, ttree)
    m = _manifest(tmp_path, 3)
    assert m["step"] == 3 and m["n_shards"] == 1 and isinstance(m["time"], float)
    assert m["leaves"] == sorted(bridge.leaf_keys(ttree)) == sorted(jflatten(jtree))
    back = JManager(str(tmp_path)).restore(3, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    _assert_same_bits(ttree, back)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", TREES)
def test_reference_writes_the_port_restores_and_serves(kind, dtype, tmp_path):
    jtree = _reference_tree(kind, dtype)
    JManager(str(tmp_path)).save(5, jtree)
    assert _manifest(tmp_path, 5)["leaves"] == sorted(bridge.leaf_keys(_port(jtree)))
    back = CheckpointManager(str(tmp_path)).restore(5, _zeros_like_port(_port(jtree)))
    _assert_same_bits(back, jtree)
    if kind == "train_state":
        assert isinstance(back[1], AdamState) and back[1].step.dtype == torch.int32
        return
    net = make_network(kind, **KW, **NETS[kind])
    with DerivativeServer.from_checkpoint(str(tmp_path), net, dtype=DTYPES[dtype][1],
                                          device="cpu", autostart=False) as srv:
        _assert_same_bits(srv.params, jtree)


@pytest.mark.parametrize("kind", ["dense", "transformer", "train_state"])
def test_bfloat16_is_written_widened_and_read_back_by_bits(kind, tmp_path):
    """The port writes bfloat16 leaves as float32 (exact) and either
    manager casts them back through ``like``; the reference's bfloat16
    records are void (``|V2``) to numpy, and the port reads their bits."""
    jtree = _reference_tree(kind, "bfloat16")
    ttree = _port(jtree)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "reference")
    CheckpointManager(mine).save(1, ttree)
    with np.load(os.path.join(mine, "step_0000000001", "shard_0.npz")) as z:
        stored = {k: z[k].dtype for k in z.files}
    assert {str(d) for k, d in stored.items() if not k.endswith(".step")} == {"float32"}
    like_j = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    _assert_same_bits(ttree, JManager(mine).restore(1, like_j))
    _assert_same_bits(CheckpointManager(mine).restore(1, _zeros_like_port(ttree)), jtree)
    JManager(theirs).save(1, jtree)
    with np.load(os.path.join(theirs, "step_0000000001", "shard_0.npz")) as z:
        assert any(z[k].dtype.kind == "V" for k in z.files)
    _assert_same_bits(CheckpointManager(theirs).restore(1, _zeros_like_port(ttree)), jtree)


def test_restore_names_missing_and_extra_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2), "b": (torch.ones(3),)})
    with pytest.raises(ValueError, match=r"missing from the checkpoint: \['c'\]"
                                         r"(.|\n)*absent from `like`: \['b/0'\]"):
        mgr.restore(1, {"a": torch.zeros(2), "c": torch.zeros(3)})
    with pytest.raises(ValueError, match="missing"):
        bridge.load_jax_checkpoint(str(tmp_path), make_network("dense", **KW), device="cpu")


@pytest.mark.parametrize("age_s,swept", [(7200.0, True), (0.0, False)],
                         ids=["stale", "fresh"])
def test_stale_tmp_sweep(tmp_path, age_s, swept):
    """A ``step_<N>.tmp`` untouched for ``stale_tmp_age_s`` (a crashed
    writer's) goes when a manager opens the directory; a fresh one (a live
    writer's) stays, and ``all_steps`` never lists either."""
    CheckpointManager(str(tmp_path)).save(2, {"w": torch.ones(2)})
    tmp = tmp_path / "step_0000000009.tmp"
    tmp.mkdir()
    (tmp / "shard_0.npz").write_bytes(b"partial")
    then = time.time() - age_s
    os.utime(tmp, (then, then))
    mgr = CheckpointManager(str(tmp_path), stale_tmp_age_s=3600.0)
    assert tmp.exists() is not swept
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
