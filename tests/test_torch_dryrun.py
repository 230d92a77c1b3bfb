"""The port's dry run (``repro_torch.launch.dryrun``) and the sharded LM
steps it holds fixed, in child processes (``tests/_torch_ranks.py``),
side by side:

* the reference's small-mesh cell (``tests/test_distributed_subproc.py``'s
  ``test_dryrun_lower_compile_small_mesh``): reduced granite trained at
  ShapeCfg("t", 64, 8) with FSDP on a fake (2, 2, 2) mesh, its FLOPs
  against the reference's ``hlo_static.analyze`` of the same cell,
  compiled in its own interpreter on 8 forced host devices;
* the cells whose steps raised in DTensor before the repairs,
  llama4's ``prefill_32k`` and rwkv6's and mixtral's ``train_4k``
  (``launch/dryrun_gate.py``'s cells), at their
  published widths on the fake production meshes (depth cut): each runs
  to its end, and its dot FLOPs and collective bytes are the gate's, which
  ``chip_smoke.py`` holds the card's torch to;
* zamba2's group of 6 (its op log): mamba's ``out_proj`` contracts each
  rank's K / 16 (a row-parallel product), whatever layout its input
  arrives in;
* llama4's ``prefill_32k`` on the multi-pod mesh at 2 and at 4 layers: a
  rank's GiB fits the card's 80 and grows by no more than the two layers'
  parameters and KV cache;
* the uneven GQA split with numbers: reduced qwen3 and mixtral with 16
  query heads, sharded over "model", against 2 kv heads on a real (1, 4)
  gloo mesh, trained, prefilled and decoded against the reference within
  1e-11 (float64, both packages' float32 islands lifted, as
  ``tests/test_torch_sharding_ranks.py``).
"""

import gzip
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R
from _torch_lm import islands, reference_train_steps
from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import decode_state_specs as jdecode_state_specs
from repro.models import decode_step as jdecode_step
from repro.models import forward_seq as jforward_seq
from repro.models import layers as jlayers
from repro.models.transformer import Knobs as JKnobs
from repro_torch import bridge
from repro_torch.launch import dryrun_gate
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-11
JKNOBS = JKnobs(q_chunk=R.SHARD_CHUNKS[0], kv_chunk=R.SHARD_CHUNKS[1])

# The port counts 26.8% more FLOPs than the reference on the small-mesh
# cell (54 427 648 against 42 925 568, torch 2.13 and this jax): the
# reduced config shards the head_dim over "model", and the port runs each
# chunk of blocked attention on the whole head_dim, replicated over
# "model" (DTensor's own rules for the split products fail in their
# backward at llama4's 40 heads), where GSPMD contracts each rank's half of
# the head_dim and all-reduces the partial scores.
TOL_SMALL_MESH = 0.30

# (arch, shape, mesh, layers): the gate's cells (``launch/dryrun_gate.py``):
# the cells that raised in DTensor's sharding propagation, at their
# published widths, the depth cut to one layer, or one group where a layer
# alone would leave weights unused (zamba2's shared block follows its group
# of 6) or skip the fault (llama4's second layer is its MoE layer); and
# llama4's prefill at 2 layers; and the two training cells whose backward
# the torch versions reduced differently.  zamba2 runs in a child of its
# own (its op log kept), the prefill cells in another.
FAULT_CELLS = tuple(dryrun_gate.CELLS)
ZAMBA2 = ("zamba2-2.7b", "train_4k", "single", 6)
# rwkv6's and mixtral's training cells, whose backward the torch versions
# reduced differently before the models stated it, in a child of their own
BACKWARD_CELLS = (("rwkv6-3b", "train_4k", "single", 1), ("mixtral-8x7b", "train_4k", "multi", 1))
# llama4's prefill at 4 layers beside the gate's 2 (the depth check)
LLAMA4_DEEPER = ("llama4-maverick-400b-a17b", "prefill_32k", "multi", 4)
CARD_GIB = 80.0

REFERENCE_SMALL_MESH = """
    import jax
    from repro.configs import get_arch
    from repro.configs.base import ShapeCfg
    from repro.launch import sharding as shd
    from repro.launch.hlo_static import analyze

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    built = shd.build_train_step(get_arch("granite-3-2b").reduced(), mesh,
                                 ShapeCfg("t", 64, 8, "train"), fsdp=True)
    with mesh:
        compiled = built.fn.lower(*built.arg_specs).compile()
    print("flops", analyze(compiled.as_text()).flops)
"""


def _reference_small_mesh():
    """The reference's cell in its own interpreter (8 forced host devices)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TF_CPP_MIN_LOG_LEVEL="2",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=8").strip())
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE_SMALL_MESH)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _jcfg(arch):
    return jget_arch(arch).reduced(dtype="float64", **R.GQA_HEADS)


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, bridge.params_to_numpy(params))


def _gqa_case(arch):
    """The GQA case's parameters and batches, rebuilt as the ranks build
    them (``init_model`` at seed 0, ``synthetic_batch`` at steps 0, 1)."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import init_model
    cfg = R.gqa_cfg(arch)
    params = init_model(cfg, 0, device="cpu")
    batches = [synthetic_batch(cfg, ShapeCfg("b", R.SHARD_S, R.SHARD_B, "train"), i,
                               dtype=torch.float64, device="cpu") for i in range(2)]
    return params, batches


def _reference_gqa(arch):
    """The reference's two training steps, last-position prefill logits and
    GQA_DECODE_TOKENS decode steps of the case."""
    params, batches = _gqa_case(arch)
    jcfg = _jcfg(arch)
    jshape = JShapeCfg("t", R.SHARD_S, R.SHARD_B, "train")
    losses, train_leaves = reference_train_steps(jcfg, jshape, params, batches, JKNOBS,
                                                 policy="tp")
    tokens = jnp.asarray(batches[0]["tokens"].numpy(), jnp.int32)

    def last_logits(p, b):
        x, *_ = jforward_seq(p, jcfg, b, JKNOBS)
        return jlayers.logits(p["embed"], x[:, -1:], jcfg)[:, 0]

    with islands("float64"):
        p = _jparams(params)
        prefill = np.asarray(jax.jit(last_logits)(p, {"tokens": tokens}))
        step = jax.jit(lambda p, t, st: jdecode_step(p, jcfg, t, st))
        st = jdecode_state_specs(jcfg, R.SHARD_B, R.SHARD_S, abstract=False)
        logits = []
        for i in range(R.GQA_DECODE_TOKENS):
            lg, st = step(p, tokens[:, i:i + 1], st)
            logits.append(np.asarray(lg))
    return {"losses": losses, "params": train_leaves, "prefill": prefill,
            "logits": np.stack(logits), "state": jax.tree_util.tree_leaves(st)}


def _references():
    proc = _reference_small_mesh()
    gqa = {arch: _reference_gqa(arch) for arch in R.GQA_ARCHS}
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    flops = float(next(line.split()[1] for line in out.splitlines()
                       if line.startswith("flops")))
    return {"gqa": gqa, "small_mesh_flops": flops}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake-group children (the gate's cells in four, llama4's deeper
    prefill, the small mesh) and the four gloo ranks, side by side; the
    references in the parent meanwhile."""
    tmp = {name: tmp_path_factory.mktemp(name.replace(":", "_")) for name in
           ("dryrun_cells:a", "dryrun_cells:b", "dryrun_cells:c", "dryrun_cells:d",
            "dryrun_cells:e", "dryrun_small_mesh", "gqa_ranks")}
    prefill = tuple(c for c in FAULT_CELLS if c[1] == "prefill_32k")
    rest = tuple(c for c in FAULT_CELLS if c != ZAMBA2 and c not in prefill
                 and c not in BACKWARD_CELLS)
    out = R.spawn_many({"dryrun_cells:a": (1, tmp["dryrun_cells:a"], {"cells": rest}),
                        "dryrun_cells:e": (1, tmp["dryrun_cells:e"],
                                           {"cells": BACKWARD_CELLS}),
                        "dryrun_cells:b": (1, tmp["dryrun_cells:b"],
                                           {"cells": (ZAMBA2,),
                                            "trace_dir": str(tmp["dryrun_cells:b"])}),
                        "dryrun_cells:c": (1, tmp["dryrun_cells:c"], {"cells": prefill}),
                        "dryrun_cells:d": (1, tmp["dryrun_cells:d"],
                                           {"cells": (LLAMA4_DEEPER,)}),
                        "dryrun_small_mesh": (1, tmp["dryrun_small_mesh"], {}),
                        "gqa_ranks": (4, tmp["gqa_ranks"], {})},
                       timeout=900, meanwhile=_references)
    cells = {**out["dryrun_cells:a"][0], **out["dryrun_cells:b"][0],
             **out["dryrun_cells:c"][0], **out["dryrun_cells:e"][0]}
    with gzip.open(tmp["dryrun_cells:b"] / "zamba2-2.7b__train_4k__single.ops.gz", "rt") as f:
        zamba2_log = json.load(f)
    return {"cells": cells, "deeper": next(iter(out["dryrun_cells:d"][0].values())),
            "zamba2_log": zamba2_log, "small_mesh": out["dryrun_small_mesh"][0],
            "gqa": out["gqa_ranks"], "reference": out["meanwhile"]}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_small_mesh_flops_against_reference(runs):
    got, want = runs["small_mesh"]["flops"], runs["reference"]["small_mesh_flops"]
    assert got > 0 and runs["small_mesh"]["collective_bytes"] > 0
    assert abs(got - want) / want <= TOL_SMALL_MESH, (got, want)


@pytest.mark.parametrize("cell", [f"{a}/{s}/{m}" for a, s, m, _ in FAULT_CELLS])
def test_fault_cell_runs_to_its_end(runs, cell):
    """The cell's step ran on the fake production mesh: its roofline is
    finite and every term positive, and its per-rank memory is counted."""
    rec = runs["cells"][cell]
    assert "error" not in rec
    assert rec["n_chips"] == (512 if cell.endswith("multi") else 256)
    for key in ("hlo_gflops", "hlo_gbytes", "compute_s", "memory_s", "per_device_mem_gb",
                "model_gflops"):
        assert np.isfinite(rec[key]) and rec[key] > 0, (key, rec[key])
    assert rec["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("cell", [f"{a}/{s}/{m}" for a, s, m, _ in FAULT_CELLS])
def test_gate_counts_hold_on_this_cpu(runs, cell):
    """The cell's dot FLOPs and collective bytes of each kind are the
    gate's (``dryrun_gate.CELLS``, which the card's torch is held to): a
    change of the port that moves them moves the gate with it."""
    a, s, m = cell.split("/")
    key = next(c for c in FAULT_CELLS if c[:3] == (a, s, m))
    rec = runs["cells"][cell]
    assert dryrun_gate.differences(rec, dryrun_gate.CELLS[key], rtol=dryrun_gate.CPU_RTOL,
                                   floor=0) == []


def test_zamba2_out_proj_is_row_parallel(runs):
    """Every product into zamba2's residual stream -- a (tokens, d_model)
    result -- contracts less than mamba's d_inner, and mamba's out_proj,
    one a layer forward and again in its recomputation, contracts each
    rank's d_inner / 16 = 320.  Gathered, it would contract all 5120, as
    it did on torch 2.11 when its input arrived replicated."""
    log = runs["zamba2_log"]
    tokens = 256 // 16 * 4096                  # a rank's rows: batch over "data"
    d_model, d_inner = 2560, 5120
    ks = {}
    for op, flops, res, _, _, _, n in log["log"]:
        if op == "aten.mm" and res == tokens * d_model * 2:     # bf16
            k = flops // (2 * tokens * d_model)
            ks[k] = ks.get(k, 0) + n
    assert max(ks) < d_inner, ks
    assert ks.get(d_inner // 16) == 2 * log["layers"], ks


def test_llama4_prefill_fits_and_does_not_grow(runs):
    """llama4 ``prefill_32k`` on the multi-pod mesh: at 2 layers a rank
    needs less than the card's 80 GiB, and 2 more layers add no more than
    their parameters (the arguments' growth) and their KV cache, plus
    10%.  Before its MoE dispatch packed each rank's experts alone, a
    rank held whole (E, capacity) buffers: 96.49 GiB at 2 layers.  (That
    tree grew by 0.24 GiB to 4 layers: nothing outlived its layer.)"""
    two = runs["cells"]["llama4-maverick-400b-a17b/prefill_32k/multi"]
    four = runs["deeper"]
    assert (two["layers"], four["layers"]) == (2, 4)
    assert two["per_device_mem_gb"] < CARD_GIB, two["per_device_mem_gb"]
    # two layers' K and V, bf16: a rank's batch row (32 over pod x data),
    # the 8 kv heads whole (16 "model" ranks do not divide them)
    kv_gib = 2 * 2 * 1 * 32768 * 8 * 128 * 2 / 2**30
    params_gib = four["argument_gb"] - two["argument_gb"]
    growth = four["per_device_mem_gb"] - two["per_device_mem_gb"]
    assert growth <= 1.1 * (params_gib + kv_gib), (growth, params_gib, kv_gib)


def test_gate_compare_holds_sweeps_cell_by_cell(tmp_path):
    """``dryrun_gate.compare`` matches two sweeps' cells by file name and
    holds each by ``differences``: a kind 2% off differs, one 0.5% off
    or under the byte floor does not, a skipped cell is left out and an
    error differs."""
    rec = {"flops": 1e12, "collective_bytes": {"all-gather": 1e9, "all-reduce": 4.0},
           "per_device_mem_gb": 1.0}
    cells = {"same": dict(rec, collective_bytes={"all-gather": 1.005e9, "all-reduce": 8.0}),
             "off": dict(rec, collective_bytes={"all-gather": 1.02e9, "all-reduce": 4.0}),
             "skip": {"skipped": "pure full-attention arch"},
             "err": {"error": "RuntimeError('boom')"}}
    for side in ("a", "b"):
        (tmp_path / side).mkdir()
        for name, r in cells.items():
            (tmp_path / side / f"{name}.json").write_text(json.dumps(r if side == "a" else (
                rec if name in ("same", "off") else r)))
    rows = {name: diff for name, _, _, diff in
            dryrun_gate.compare(str(tmp_path / "a"), str(tmp_path / "b"))}
    assert set(rows) == {"same.json", "off.json", "err.json"}
    assert rows["same.json"] == [] and len(rows["off.json"]) == 1
    assert rows["err.json"] == ["RuntimeError('boom')"]


@pytest.mark.parametrize("arch", R.GQA_ARCHS)
def test_uneven_gqa_split_matches_reference(runs, arch):
    """16 query heads sharded 4 ways (4 a rank) against 2 kv heads, which 4
    ranks do not divide: the kv projection stays replicated, and training,
    prefill and decode match the reference."""
    want = runs["reference"]["gqa"][arch]
    for out in runs["gqa"]:
        got = out[arch]
        assert got["placements"] == {"wq": "(Replicate(), Shard(dim=2))",
                                     "wk": "(Replicate(), Replicate())"}
        assert _rel(got["losses"], want["losses"]) <= TOL
        ps = leaves(got["params"])
        assert len(ps) == len(want["params"])
        assert max(_rel(a.numpy(), b) for a, b in zip(ps, want["params"])) <= TOL
        assert _rel(got["prefill"].numpy(), want["prefill"]) <= TOL
        assert _rel(got["logits"].numpy(), want["logits"]) <= TOL
        state = leaves(got["state"])
        assert len(state) == len(want["state"])
        for a, b in zip(state, want["state"]):
            assert _rel(a.numpy(), b) <= TOL
