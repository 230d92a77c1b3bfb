"""The port's LM sharding layer against the JAX package's, in one process
(no process group, no JAX device beyond the default one).

Every arch at its **published** widths: the logical spec tree the port's
init functions build (``param_specs``) against the reference's
``init_model(cfg, abstract=True)`` specs, the bound spec of every leaf on
both production meshes (16 x 16, 2 x 16 x 16) with FSDP on and off and both
policies, the decode-state specs at ``decode_32k`` and ``long_500k``, the
parameter counts, the FSDP choice and the abstract inputs.  The port binds
``{name: size}`` mappings; the reference's binders read only a mesh's
``axis_names`` and ``shape``, so a stand-in carrying those serves it, and
its ``bind_param_shardings`` is taken leaf by leaf (``fsdp_extend``,
``bind_pspec``, ``sanitize_spec``: it builds ``NamedSharding`` on a real
mesh otherwise).

Then the yardstick of ``tests/test_torch_sharding_ranks.py``: the
reference's ``build_train_step`` on an in-process (1, 1) mesh against the
port's unsharded training step, float64 with the float32 islands lifted,
within 1e-11.
"""

import math
from functools import lru_cache
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import reference_train_steps
from repro.configs import get_arch as jget_arch
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import sharding as jsh
from repro.models import sharding_rules as jrules
from repro.models import transformer as jtfm
from repro.runtime.pipeline import pipeline_bubble_fraction as jbubble
from repro_torch.configs import ASSIGNED, SHAPES, get_arch, shape_applicable
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import production_sizes
from repro_torch.models import param_specs, sharding_rules as rules_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding_rules import (Rules, Spec, make_rules, placements, shard,
                                               spec_leaves, use_rules)
from repro_torch.runtime.pipeline import pipeline_bubble_fraction
from repro_torch.tree import leaves

P = jax.sharding.PartitionSpec
MESHES = {"16x16": production_sizes(False), "2x16x16": production_sizes(True)}


def _stand_in(sizes):
    """What the reference's binders read of a mesh."""
    return SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _is_p(x):
    return isinstance(x, P)


def _tuples(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(specs, is_leaf=_is_p)]


@lru_cache(maxsize=None)
def _reference_init(arch):
    return jtfm.init_model(jget_arch(arch), abstract=True)


@lru_cache(maxsize=None)
def _port_init(arch):
    cfg = get_arch(arch)
    return tfm.init_model(cfg, abstract=True), param_specs(cfg)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_reference(arch):
    """The logical spec of every leaf, and every leaf's shape and dtype, at
    published widths: the same tree built by the same init functions."""
    jparams, jspecs = _reference_init(arch)
    params, specs = _port_init(arch)
    assert [tuple(s) for s in spec_leaves(specs)] == _tuples(jspecs)
    jl = jax.tree_util.tree_leaves(jparams)
    pl = leaves(params)
    assert [tuple(x.shape) for x in pl] == [tuple(x.shape) for x in jl]
    assert {str(x.dtype).replace("torch.", "") for x in pl} == {str(x.dtype) for x in jl}
    assert all(x.device.type == "meta" for x in pl)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_count_and_fsdp_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert sh.arch_param_count(cfg) == jsh.arch_param_count(jcfg)
    assert sh.wants_fsdp(cfg) == jsh.wants_fsdp(jcfg)


BIND_CASES = [(arch, mesh, fsdp, policy) for arch in ASSIGNED for mesh in MESHES
              for fsdp in (False, True) for policy in ("tp", "dp")]


@pytest.mark.parametrize("arch,mesh,fsdp,policy", BIND_CASES,
                         ids=["-".join(map(str, c)) for c in BIND_CASES])
def test_bound_specs_match_reference(arch, mesh, fsdp, policy):
    """Every leaf's bound spec: FSDP-extended where the leaf is large
    enough, bound to the mesh's axes, sanitized for divisibility."""
    sizes = MESHES[mesh]
    jmesh = _stand_in(sizes)
    jr = jrules.make_rules(jmesh, fsdp=fsdp, policy=policy)
    r = make_rules(sizes, fsdp=fsdp, policy=policy)
    assert (r.batch, r.model, r.seq, r.fsdp) == (jr.batch, jr.model, jr.seq, jr.fsdp)
    jparams, jspecs = _reference_init(arch)
    axis_size = sizes.get("data", 1)

    def bind(spec, leaf):
        if jr.fsdp and math.prod(leaf.shape) >= jsh.FSDP_LEAF_MIN:
            spec = jsh.fsdp_extend(spec, leaf.shape, jr, axis_size)
        return jsh.sanitize_spec(jrules.bind_pspec(spec, jr), leaf.shape, jmesh)

    want = _tuples(jax.tree_util.tree_map(bind, jspecs, jparams, is_leaf=_is_p))
    params, specs = _port_init(arch)
    got = [tuple(s) for s in spec_leaves(sh.bind_param_specs(sizes, specs, params, r))]
    assert got == want
    # the shardings carry these specs, on the mapping standing in for the mesh
    shardings = sh.bind_param_shardings(sizes, specs, params, r)
    assert [tuple(s.spec) for s in _sharding_leaves(shardings)] == want


def _sharding_leaves(tree):
    if isinstance(tree, sh.Sharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    return [x for v in tree for x in _sharding_leaves(v)]


STATE_CASES = [(arch, shape, mesh) for arch in ASSIGNED
               for shape in ("decode_32k", "long_500k") for mesh in MESHES
               if shape_applicable(get_arch(arch), SHAPES[shape])]


@pytest.mark.parametrize("arch,shape,mesh", STATE_CASES,
                         ids=["-".join(c) for c in STATE_CASES])
def test_state_pspecs_match_reference(arch, shape, mesh):
    """The decode state's specs (batch over (pod, data) when it divides,
    else the sequence-parallel KV of ``long_500k``), and their bound,
    sanitized form leaf by leaf."""
    sizes = MESHES[mesh]
    jmesh = _stand_in(sizes)
    sp = SHAPES[shape].global_batch == 1
    jr = jrules.make_rules(jmesh, sp=sp)
    r = make_rules(sizes, sp=sp)
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    want = jsh.state_pspecs(jcfg, JSHAPES[shape], jr, jmesh)
    got = sh.state_pspecs(cfg, SHAPES[shape], r, sizes)
    assert sorted(got) == sorted(want)
    for key in want:
        assert [tuple(s) for s in spec_leaves(got[key])] == _tuples(want[key]), key
    jst = jtfm.decode_state_specs(jcfg, SHAPES[shape].global_batch, SHAPES[shape].seq_len)
    bound = jax.tree_util.tree_map(
        lambda s, leaf: jsh.sanitize_spec(jrules.bind_pspec(s, jr), leaf.shape, jmesh),
        want, jst, is_leaf=_is_p)
    shardings = sh.state_shardings(sizes, cfg, SHAPES[shape], r)
    assert [tuple(s.spec) for s in _sharding_leaves(shardings)] == _tuples(bound)


INPUT_CASES = [(arch, shape) for arch in ASSIGNED for shape in SHAPES
               if shape_applicable(get_arch(arch), SHAPES[shape])]


@pytest.mark.parametrize("arch,shape", INPUT_CASES, ids=["-".join(c) for c in INPUT_CASES])
def test_abstract_inputs_match_reference(arch, shape):
    want = jsh.abstract_inputs(jget_arch(arch), JSHAPES[shape])
    got = sh.abstract_inputs(get_arch(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        assert got[k].device.type == "meta"
    r = make_rules(MESHES["2x16x16"])
    jr = jrules.make_rules(_stand_in(MESHES["2x16x16"]))
    for k in want:
        assert tuple(sh.batch_pspec(r, got[k].ndim)) == tuple(jsh.batch_pspec(jr, want[k].ndim))


def test_placements_of_a_two_axis_dim():
    """A dim bound to ("pod", "data") shards over both mesh dims, the pod
    axis major (JAX's layout; DTensor splits in mesh order); an axis of
    size 1 places Replicate; axes out of the mesh's order are refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert placements(Spec(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(Spec(None, ("pod", "data")), mesh) == (Shard(1), Shard(1), Replicate())
    assert placements(Spec(), mesh) == (Replicate(),) * 3
    assert placements(Spec("data", "model"), {"data": 1, "model": 4}) == \
        (Replicate(), Shard(1))
    with pytest.raises(NotImplementedError):
        placements(Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        placements(Spec("data", "data"), mesh)


def test_shard_is_a_no_op_without_rules_or_dtensor():
    x = torch.ones(4, 3)
    assert rules_mod.active_rules() is None
    assert shard(x, "batch", None) is x
    with use_rules(make_rules(MESHES["16x16"])):
        assert rules_mod.active_rules() == Rules(batch=("data",), model=("model",))
        assert shard(x, "batch", "model") is x
    assert rules_mod.active_rules() is None
    assert rules_mod.bind_pspec(Spec("fsdp", ("model", "fsdp")), make_rules(
        MESHES["16x16"], fsdp=True)) == Spec("data", ("model", "data"))


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (4, 6), (4, 16), (16, 4)])
def test_pipeline_bubble_fraction(n_stages, n_micro):
    assert pipeline_bubble_fraction(n_stages, n_micro) == jbubble(n_stages, n_micro)


def test_reference_sharded_train_step_is_the_port_step():
    """The reference's ``build_train_step`` on an in-process (1, 1) mesh
    (two steps, qwen3 reduced) against the port's unsharded training step
    (``launch.train.train_step``) from the same parameters and batches,
    float64 with both packages' float32 islands lifted (the models', Adam's):
    losses and every parameter leaf within 1e-11 of their max |ref|."""
    import _torch_ranks as R
    from repro.configs.base import ShapeCfg as JShapeCfg
    from repro.models.transformer import Knobs as JKnobs
    from repro_torch.launch.train import train_step
    from repro_torch.optim import adam_init

    arch = "qwen3-0.6b"
    cfg, shape, params, batches = R.shard_case(arch, "train")
    jshape = JShapeCfg(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    want_losses, want = reference_train_steps(jget_arch(arch).reduced(dtype="float64"),
                                              jshape, params, batches, JKnobs())
    step = train_step(cfg, 3e-4)
    p, o, losses = params, adam_init(params), []
    with R.lifted_islands():
        for b in batches:
            p, o, loss, *_ = step(p, o, b)
            losses.append(float(loss))
    assert np.allclose(losses, want_losses, rtol=1e-11, atol=0)
    got = leaves(p)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-11 * np.abs(b).max()
