"""What each rank runs in the port's multi-process tests: data parallel
(``tests/test_torch_parallel.py``) and the LM substrate's sharding half
(``tests/test_torch_sharding_ranks.py``).

``spawn(world_size, scenario, tmp_path)`` starts ``world_size`` processes
(spawn start method), each of which joins a gloo process group initialised
from a file under ``tmp_path`` (no TCP port is chosen), runs
``SCENARIOS[scenario]`` on the CPU and saves what it returns to
``tmp_path/rank<r>.pt``; the parent gets those back.  A child that raises
fails the spawn (``torch.multiprocessing`` ends the others), and a spawn
that outlives its deadline is killed and fails.  This module imports only
torch and the port, so the children never load JAX.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.tree import bit_equal

F64 = torch.float64


def spawn(world_size: int, scenario: str, tmp_path, timeout: float = 600.0,
          **kwargs) -> list:
    return spawn_many({scenario: (world_size, tmp_path, kwargs)}, timeout)[scenario]


def spawn_many(jobs: dict, timeout: float = 600.0, meanwhile=None) -> dict:
    """Several spawns at once: ``{scenario: (world_size, tmp_path,
    kwargs)}`` -> ``{scenario: [each rank's result]}``; a key may add
    ":label" to its scenario's name, to run one scenario several times.
    Each job has its own group (its own ``tmp_path``); all run side by
    side, the parent runs ``meanwhile()`` while they do (its result under
    the key ``"meanwhile"``), and a job that fails or outlives ``timeout``
    fails the call."""
    import torch.multiprocessing as mp
    ctxs = {name: mp.start_processes(_entry, args=(ws, str(tmp), name.split(":")[0], kw),
                                     nprocs=ws, join=False, start_method="spawn")
            for name, (ws, tmp, kw) in jobs.items()}
    deadline = time.monotonic() + timeout
    try:
        done = meanwhile() if meanwhile is not None else None
        for name, ctx in ctxs.items():
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name} at world size {jobs[name][0]} outlived "
                                       f"{timeout} s")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    out = {name: [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                  for r in range(ws)]
           for name, (ws, tmp, _) in jobs.items()}
    out["meanwhile"] = done
    return out


def _entry(rank: int, world_size: int, tmp: str, scenario: str, kwargs: dict) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    if scenario not in FAKE_GROUP:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'init')}",
                                world_size=world_size, rank=rank)
    try:
        out = SCENARIOS[scenario](world_size, **kwargs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel(a, b) -> float:
    return _max_diff(a, b) / max(float(b.abs().max()), 1e-300)


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def engine_tables(world_size: int, networks=("dense",), operators=None, orders=(4,),
                  sizes=(19, 3)) -> dict:
    """ShardedEngine(ntp and ntp/cuda) against the single-process call:
    grid at ``orders``, every cross the operator declares (or (0, 1)), and
    derivs along a random tangent, per operator, network and batch size.
    Returns per (impl, network) the largest |difference| relative to the
    table's largest |value|."""
    from repro_torch.core.engines import NTPEngine
    from repro_torch.core.network import make_network
    from repro_torch.data.collocation import sample_box
    from repro_torch.parallel import DataMesh, ShardedEngine
    from repro_torch.pinn.operators import get_operator, operator_names

    mesh = DataMesh()
    worst = {}
    for impl in ("torch", "cuda"):
        eng = NTPEngine(impl)
        sh = ShardedEngine(eng, mesh)
        assert sh.spec == eng.spec and sh.n_shards == world_size
        for kind in networks:
            w = 0.0
            for name in operators or operator_names():
                op = get_operator(name)
                extra = dict(n_heads=2) if kind == "transformer" else {}
                net = make_network(kind, d_in=op.d_in, d_out=op.d_out,
                                   width=4 if kind == "transformer" else 6, depth=2,
                                   **extra)
                params = net.init(torch.Generator().manual_seed(0), F64, device="cpu")
                gen = torch.Generator().manual_seed(1)
                for n in sizes:
                    x = sample_box(gen, op.domain, n, F64, "cpu")
                    for order in orders:
                        got, ref = sh.grid(net, params, x, order), eng.grid(net, params, x, order)
                        assert got.shape == (op.d_in, order + 1, n, op.d_out)
                        w = max(w, _rel(got, ref))
                    for axes in op.mixed or (tuple(range(min(op.d_in, 2))),):
                        w = max(w, _rel(sh.cross(net, params, x, axes),
                                        eng.cross(net, params, x, axes)))
                    v = torch.rand(x.shape, generator=gen, dtype=F64)
                    w = max(w, _rel(sh.derivs(net, params, x, 3, v),
                                    eng.derivs(net, params, x, 3, v)))
            worst[f"{impl}/{kind}"] = w
    return worst


def _toy_loss(params, pts):
    pred = pts @ params["w"] + params["b"]
    loss = torch.mean((pred - torch.sin(pts[:, :1])) ** 2)
    return loss, {"residual": loss}


def toy_problem():
    """The reference's toy train-step problem (tests/test_jet_shard.py), at
    24 points from numpy (a multiple of 2, 3 and 4 ranks)."""
    params = {"w": torch.full((3, 1), 0.1, dtype=F64), "b": torch.zeros((1,), dtype=F64)}
    pts = torch.from_numpy(np.random.default_rng(0).uniform(size=(24, 3)))
    return params, pts


def training(world_size: int) -> dict:
    """The sharded Adam step (4 steps of the toy problem; the compressed
    steps 30), pinn_loss(mesh=) and its gradient, the sharded L-BFGS
    objective's gradient, train_operator(data_parallel=) against the
    single-process run, and error-feedback accumulation over the real
    reduce."""
    import torch.distributed as dist
    from repro_torch.optim import adam_init
    from repro_torch.parallel import (DataMesh, build_sharded_train_step,
                                      compressed_psum_tree, resolve_mesh, topk_psum_tree)
    from repro_torch.pinn import OperatorRunConfig, train_operator
    from repro_torch.pinn.trainer import (adam_step, make_operator_net, operator_loss_fn,
                                          value_and_grad)
    from repro_torch.data.collocation import sample_box
    from repro_torch.pinn.operators import get_operator
    from repro_torch.tree import leaves

    out = {}
    mesh = resolve_mesh(None, world_size)
    assert isinstance(mesh, DataMesh) and mesh.shape == {"data": world_size}
    try:
        resolve_mesh(None, world_size + 1)
    except ValueError as e:
        out["wrong_world_size"] = str(e)

    # --- the sharded Adam step against the single-process step
    params, pts = toy_problem()
    built = build_sharded_train_step(_toy_loss, mesh, adam_lr=1e-2)
    assert built.n_shards == world_size and built.compression is None
    err = built.init_err(params)
    p_sh, s_sh, p_one, s_one = params, adam_init(params), params, adam_init(params)
    losses, aux_res = [], []
    for _ in range(4):
        p_sh, s_sh, (loss, aux), err = built.step(p_sh, s_sh, pts, err)
        p_one, s_one, loss_one, _ = adam_step(_toy_loss, p_one, s_one, 1e-2, pts)
        losses.append((float(loss), float(loss_one)))
        aux_res.append(float(aux["residual"]))
    out["adam"] = {"params": p_sh, "single": p_one, "losses": losses, "aux": aux_res,
                   "err_max": max(float(e.abs().max()) for e in leaves(err))}
    try:
        built.step(p_sh, s_sh, pts[:world_size * 3 + 1], err)
    except ValueError as e:
        out["indivisible_batch"] = str(e)

    # --- compressed steps descend
    for spec in ("int8", "topk:0.5"):
        c = build_sharded_train_step(_toy_loss, mesh, adam_lr=1e-2, compression=spec)
        p, s, e = params, adam_init(params), c.init_err(params)
        hist = []
        for _ in range(30):
            p, s, (loss, _), e = c.step(p, s, pts, e)
            hist.append(float(loss))
        out[f"descent/{spec}"] = hist

    # --- error feedback over the real reduce: the running mean of the
    # compressed sums converges to the exact sum
    g_all = torch.from_numpy(np.random.default_rng(0).normal(size=(world_size, 128)) * 3.0
                             ).float()
    true = g_all.sum(0)
    g = g_all[dist.get_rank()]
    for spec, comp in (("int8", compressed_psum_tree),
                       ("topk:0.2", lambda gg, ee, grp: topk_psum_tree(gg, ee, grp, 0.2))):
        e, acc = [torch.zeros(128)], torch.zeros(128)
        for _ in range(50):
            red, e = comp([g], e, None)
            acc = acc + red[0]
        out[f"ef/{spec}"] = float((acc / 50 - true).abs().max() / true.abs().max())

    # --- pinn_loss(mesh=) and the sharded L-BFGS objective's gradient
    for kind in ("dense", "transformer"):
        cfg = OperatorRunConfig(op="heat", network=kind, width=8 if kind == "dense" else 4,
                                depth=2, n_bc=8, engine="ntp",
                                net_kwargs=dict(n_heads=2) if kind == "transformer" else {})
        net = make_operator_net(cfg)
        p = net.init(torch.Generator().manual_seed(0), F64, device="cpu")
        x = sample_box(torch.Generator().manual_seed(1), get_operator("heat").domain, 13,
                       F64, "cpu")
        (l1, a1), g1 = value_and_grad(operator_loss_fn(cfg, net, "cpu"), p, x)
        (l2, a2), g2 = value_and_grad(operator_loss_fn(cfg, net, "cpu", mesh), p, x)
        out[f"pinn_loss/{kind}"] = {
            "loss": (float(l2), float(l1)),
            "aux": {k: (float(a2[k]), float(a1[k])) for k in a1},
            "grad_rel": max(_rel(b, a) for a, b in zip(leaves(g1), leaves(g2)))}

    # --- train_operator(data_parallel=) against the single-process run
    base = dict(op="heat", width=8, depth=2, n_domain=8 * world_size, n_bc=8, adam_steps=6,
                lbfgs_steps=2, log_every=1, eval_pts_per_axis=8)
    one = train_operator(OperatorRunConfig(**base), device="cpu")
    dp = train_operator(OperatorRunConfig(**base, data_parallel=world_size), device="cpu")
    explicit = train_operator(OperatorRunConfig(**base, mesh=mesh), device="cpu")
    out["train"] = {"single": one.loss_history, "sharded": dp.loss_history,
                    "mesh": explicit.loss_history,
                    "params_rel": max(_rel(b, a) for a, b in zip(leaves(one.params),
                                                                 leaves(dp.params))),
                    "l2": (dp.l2_error, one.l2_error)}
    comp = train_operator(OperatorRunConfig(**{**base, "lbfgs_steps": 0, "adam_steps": 20},
                                            data_parallel=world_size,
                                            grad_compression="int8"), device="cpu")
    out["train_int8"] = comp.loss_history
    try:
        train_operator(OperatorRunConfig(**{**base, "n_domain": 8 * world_size + 1},
                                         data_parallel=world_size), device="cpu")
    except ValueError as e:
        out["indivisible_n_domain"] = str(e)
    return out


def serving(world_size: int) -> dict:
    """DerivativeServer(mesh=) across the ranks against direct engine calls;
    the mesh in the cache key, the bucket guard and the followers'
    refusal of requests."""
    import torch.distributed as dist
    from repro_torch.core.engines import NTPEngine
    from repro_torch.core.network import make_network
    from repro_torch.parallel import DataMesh
    from repro_torch.serving import DerivativeServer

    mesh = DataMesh()
    out = {}
    for kind in ("dense", "transformer"):
        extra = dict(n_heads=2) if kind == "transformer" else {}
        net = make_network(kind, d_in=2, d_out=1, width=4 if extra else 8, depth=2, **extra)
        params = net.init(torch.Generator().manual_seed(0), F64, device="cpu")
        x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, size=(5, 2)))
        buckets = (4 * world_size, 8 * world_size)
        srv = DerivativeServer(net, params, "ntp/cuda", buckets=buckets, mesh=mesh,
                               device="cpu", flush_window_s=0.0)
        try:
            if dist.get_rank() == 0:
                eng = NTPEngine("cuda")
                got = {"grid": srv.grid(x, 3, timeout=120), "cross": srv.cross(x, (0, 1),
                                                                               timeout=120)}
                want = {"grid": eng.grid(net, params, x, 3),
                        "cross": eng.cross(net, params, x, (0, 1))}
                big = torch.from_numpy(np.random.default_rng(2).uniform(
                    -1, 1, size=(8 * world_size - 1, 2)))
                got["grid_big"] = srv.grid(big, 2, timeout=120)
                want["grid_big"] = eng.grid(net, params, big, 2)
                out[kind] = {k: _rel(got[k], want[k]) for k in got}
                out["mesh_key"] = srv.mesh_key
                out["cache_keys"] = [k.mesh for k in srv.cache._entries]
            else:
                try:
                    srv.submit(x, order=1)
                except RuntimeError as e:
                    out["follower_submit"] = str(e)
        finally:
            srv.close()
    try:
        DerivativeServer(net, params, "ntp", buckets=(world_size + 1,), mesh=mesh,
                         device="cpu")
    except ValueError as e:
        out["bucket_guard"] = str(e)
    return out


def serving_idle(world_size: int, timeout_s: float = 3.0, idle_s: float = 7.0) -> dict:
    """A sharded server on a group whose timeout (``timeout_s``) is shorter
    than the idle gap (``idle_s``) between two requests: rank 0's idle
    heartbeat keeps the other ranks' wait for the next header inside the
    timeout, so the request after the gap is answered, and equals the one
    before it."""
    import datetime

    import torch.distributed as dist
    from repro_torch.core.network import make_network
    from repro_torch.parallel import DataMesh
    from repro_torch.serving import DerivativeServer

    mesh = DataMesh(dist.new_group(timeout=datetime.timedelta(seconds=timeout_s)))
    net = make_network("dense", d_in=2, d_out=1, width=8, depth=2)
    params = net.init(torch.Generator().manual_seed(0), F64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, size=(5, 2)))
    dist.barrier()
    srv = DerivativeServer(net, params, "ntp", buckets=(4 * world_size,), mesh=mesh,
                           device="cpu", flush_window_s=0.0, heartbeat_s=timeout_s / 12)
    out = {}
    try:
        if mesh.rank == 0:
            before = srv.grid(x, 2, timeout=60)
            time.sleep(idle_s)
            after = srv.grid(x, 2, timeout=60)
            out = {"equal": bit_equal(before, after),
                   "batches": srv.metrics()["batches"]}
    finally:
        srv.close()
    return out


def pinn_loss_parity(world_size: int) -> dict:
    """pinn_loss(mesh=) and its gradient against the single-process loss on
    the heat operator's DenseMLP."""
    from repro_torch.parallel import DataMesh
    from repro_torch.pinn import OperatorRunConfig
    from repro_torch.pinn.trainer import make_operator_net, operator_loss_fn, value_and_grad
    from repro_torch.tree import leaves

    cfg = OperatorRunConfig(op="heat", width=8, depth=2, n_bc=8)
    net = make_operator_net(cfg)
    p = net.init(torch.Generator().manual_seed(0), F64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, size=(11, 2)))
    (l1, _), g1 = value_and_grad(operator_loss_fn(cfg, net, "cpu"), p, x)
    (l2, _), g2 = value_and_grad(operator_loss_fn(cfg, net, "cpu", DataMesh()), p, x)
    return {"loss": (float(l2), float(l1)),
            "grad_rel": max(_rel(b, a) for a, b in zip(leaves(g1), leaves(g2)))}


def train_parity(world_size: int) -> dict:
    """train_operator(data_parallel=N) against the single-process run."""
    from repro_torch.pinn import OperatorRunConfig, train_operator
    base = dict(op="heat", width=8, depth=2, n_domain=8 * world_size, n_bc=8, adam_steps=4,
                lbfgs_steps=2, log_every=1, eval_pts_per_axis=8)
    one = train_operator(OperatorRunConfig(**base), device="cpu")
    dp = train_operator(OperatorRunConfig(**base, data_parallel=world_size), device="cpu")
    return {"single": one.loss_history, "sharded": dp.loss_history}


def _signed_zero_rows(rank: int, dtype) -> torch.Tensor:
    """Rank ``rank``'s rows of the gather check: -0.0 and +0.0 beside
    values, each rank's different."""
    return torch.tensor([[-0.0, 0.0, 1.0 + rank], [rank - 2.5, -0.0, -0.0]], dtype=dtype)


def gather_signed_zeros(world_size: int) -> dict:
    """``gather_rows_by_sum`` on every float width against the rows each
    rank wrote, by bits; beside it the float sum of the same zero-filled
    buffers, which turns -0.0 into +0.0."""
    import torch.distributed as dist
    from repro_torch.parallel import DataMesh
    from repro_torch.parallel.jet_shard import gather_rows_by_sum

    mesh, out = DataMesh(), {}
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        want = torch.cat([_signed_zero_rows(r, dt) for r in range(world_size)])
        local = _signed_zero_rows(mesh.rank, dt)
        got = gather_rows_by_sum(local, mesh)
        summed = torch.zeros_like(want, dtype=torch.float64)
        summed[mesh.rank * 2:(mesh.rank + 1) * 2] = local.double()
        dist.all_reduce(summed)
        summed = summed.to(dt)
        out[str(dt)] = {"by_sum_bits": bit_equal(got, want),
                        "float_sum_equal": bool(torch.equal(summed, want)),
                        "float_sum_bits": bit_equal(summed, want)}
    return out


def everything(world_size: int, **engine_kwargs) -> dict:
    return {"engine": engine_tables(world_size, **engine_kwargs),
            "training": training(world_size), "serving": serving(world_size),
            "gather": gather_signed_zeros(world_size)}


# ---------------------------------------------------------------------------
# the LM substrate's sharding half (tests/test_torch_sharding_ranks.py), on a
# (2, 2) ("data", "model") mesh of 4 ranks, float64 with the islands lifted
# ---------------------------------------------------------------------------

SHARD_B, SHARD_S = 4, 32     # the LM cases' batch and sequence (granite's dp: 2 x SHARD_B)
SHARD_CHUNKS = (8, 8)        # blocked attention's query / key chunks (tests/_torch_lm.py)


class _Wide:
    """A module proxy whose ``float32`` is float64."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


def lifted_islands():
    """The port's LM modules' and Adam's float32 islands at float64 (the
    parent lifts the reference's: ``tests/test_torch_sharding_ranks.py``)."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.models import attention, gla, layers, moe, rwkv, ssm, transformer
    from repro_torch.optim import adam
    stack = ExitStack()
    for mod in (layers, attention, transformer, gla, ssm, rwkv, moe, adam):
        stack.enter_context(mock.patch.object(mod, "torch", _Wide(torch, F64)))
    return stack


def shard_cfg(arch: str):
    """The reduced float64 config of a sharding case; llama4 with 16
    experts, so its MoE layers take the expert-parallel specs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MoECfg
    extra = dict(moe=MoECfg(16, 1, 1.25, period=2)) if arch.startswith("llama4") else {}
    return get_arch(arch).reduced(dtype="float64", **extra)


def shard_case(arch: str, kind: str, batch: int = SHARD_B, steps: int = 2):
    """(cfg, shape, params, batches) of a sharding case: the port's
    ``init_model`` at seed 0 and ``synthetic_batch`` at steps 0.. (both
    deterministic, so the parent rebuilds them for the reference)."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import init_model
    cfg = shard_cfg(arch)
    shape = ShapeCfg(f"shard_{kind}", SHARD_S, batch, kind)
    params = init_model(cfg, 0, device="cpu")
    batches = [synthetic_batch(cfg, ShapeCfg("b", SHARD_S, batch, "train"), i, dtype=F64,
                               device="cpu") for i in range(steps)]
    return cfg, shape, params, batches


def _full(tree):
    from repro_torch.tree import leaves, unflatten
    return unflatten(tree, [t.full_tensor() if hasattr(t, "full_tensor") else t
                            for t in leaves(tree)])


SHARD_FSDP_LEAF_MIN = 1 << 10   # the reduced leaves are below FSDP_LEAF_MIN

# arch -> (global batch, build_train_step's keywords) of the trained cases
TRAIN_CASES = {"qwen3-0.6b": (SHARD_B, dict(policy="tp")),
               "granite-3-2b": (2 * SHARD_B, dict(policy="dp", fsdp=True, accum=2)),
               "rwkv6-3b": (SHARD_B, dict(policy="tp")),
               "mixtral-8x7b": (SHARD_B, dict(policy="tp"))}


def sharding_train(world_size: int) -> dict:
    """``build_train_step`` on the (2, 2) mesh, two steps a case of
    TRAIN_CASES: qwen3, rwkv6 (its token-shift mixes' stated backward) and
    mixtral (its balance loss's mean over groups) at ``policy="tp"``;
    granite at ``policy="dp"``, ``fsdp=True``, ``accum=2``, with FSDP on
    every leaf of SHARD_FSDP_LEAF_MIN elements or more.  Returns each
    case's losses, its gradients as they reach ``adam_update`` and its
    parameters after each step (full tensors), and the placements its
    parameters and tokens took."""
    from unittest import mock

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Knobs
    from repro_torch.optim import adam_init
    from repro_torch.tree import leaves

    mesh = make_debug_mesh(2, 2, "cpu")
    knobs = Knobs(q_chunk=SHARD_CHUNKS[0], kv_chunk=SHARD_CHUNKS[1])
    out = {}
    for arch, (batch, kw) in TRAIN_CASES.items():
        cfg, shape, params, batches = shard_case(arch, "train", batch)
        with mock.patch.object(sharding, "FSDP_LEAF_MIN", SHARD_FSDP_LEAF_MIN):
            built = sharding.build_train_step(cfg, mesh, shape, knobs=knobs, **kw)
        p, o, losses, grads, steps = params, adam_init(params), [], [], []

        def adam_update(g, *args, _update=sharding.adam_update, **kwargs):
            grads.append(_full(g))
            return _update(g, *args, **kwargs)

        with lifted_islands(), mock.patch.object(sharding, "adam_update", adam_update):
            for b in batches:
                p, o, loss, _ = built.fn(p, o, b)
                losses.append(float(loss.full_tensor()))
                steps.append(_full(p))
        tokens = sharding.input_shardings(mesh, cfg, shape, built.rules)["tokens"]
        out[arch] = {"losses": losses, "grads": grads, "params": steps,
                     "placements": sorted({str(t.placements) for t in leaves(p)}),
                     "tokens": str(tokens.placements)}
    return out


DECODE_TOKENS = {"rwkv6-3b": SHARD_S, "qwen3-0.6b": 8}


def sharding_serve(world_size: int) -> dict:
    """rwkv6 and qwen3 (its KV ring written shard by shard) decoded by
    ``build_serve_step`` from a fresh state (DECODE_TOKENS steps: every
    step's logits, the final state); mixtral (TP inside its experts) and
    llama4 (16 experts: expert parallel) prefilled by
    ``build_prefill_step``."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import build_prefill_step, build_serve_step
    from repro_torch.models import Knobs, decode_state_specs

    mesh = make_debug_mesh(2, 2, "cpu")
    knobs = Knobs(q_chunk=SHARD_CHUNKS[0], kv_chunk=SHARD_CHUNKS[1])
    out = {}
    for arch, n in DECODE_TOKENS.items():
        cfg, shape, params, (batch,) = shard_case(arch, "decode", steps=1)
        built = build_serve_step(cfg, mesh, shape, knobs=knobs)
        logits = []
        with lifted_islands():
            st = decode_state_specs(cfg, SHARD_B, SHARD_S, device="cpu")
            for i in range(n):
                lg, st = built.fn(params, batch["tokens"][:, i:i + 1], st)
                logits.append(lg.full_tensor())
        out[arch] = {"logits": torch.stack(logits), "state": _full(st)}
    for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b"):
        cfg, shape, params, (batch,) = shard_case(arch, "prefill", steps=1)
        built = build_prefill_step(cfg, mesh, shape, knobs=knobs)
        with lifted_islands():
            out[arch] = {"logits": built.fn(params, batch).full_tensor()}
    return out


def pipeline_stage(p, x):
    """The reference's pipeline test stage: shape-preserving."""
    return x + torch.tanh(x @ p)


def pipeline_case():
    """(stacked stage weights (4, 8, 8), microbatches (6, 3, 8)) from numpy."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(4, 8, 8)) * 0.5)
    xs = torch.from_numpy(rng.normal(size=(6, 3, 8)))
    return w, xs


def pipeline_loss(out):
    return (out ** 2).sum() + out.sum()


RESTORE_SHAPES = {"a": (8, 6), "b": (4, 10), "c": (12,)}


def restore_tree():
    """A small tree of float64, float32 and bfloat16 leaves from numpy."""
    rng = np.random.default_rng(1)
    return {"a": torch.from_numpy(rng.normal(size=RESTORE_SHAPES["a"])),
            "b": torch.from_numpy(rng.normal(size=RESTORE_SHAPES["b"]).astype(np.float32)),
            "c": torch.from_numpy(rng.normal(size=RESTORE_SHAPES["c"]).astype(np.float32)
                                  ).to(torch.bfloat16)}


def pipeline_restore(world_size: int, ckpt_dir: str) -> dict:
    """(c) ``gpipe`` over a 4-stage mesh against the sequential application
    (outputs; each rank's stage-weight gradient); (d) a tree saved from a
    (2, 2) mesh with placements ("data", "model") and restored onto
    ("model", "data") and onto a 1-D (4,) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import Sharding, distribute_params
    from repro_torch.models.sharding_rules import Spec
    from repro_torch.runtime.pipeline import gpipe

    rank = torch.distributed.get_rank()
    stage_mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    w, xs = pipeline_case()
    w = w.requires_grad_()
    got = gpipe(pipeline_stage, stage_mesh)(w, xs)
    grad, = torch.autograd.grad(pipeline_loss(got), w)

    mesh = make_debug_mesh(2, 2, "cpu")
    flat = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))

    def layout(m, spec):
        return {k: Sharding(m, Spec(*spec[:len(shape)])) for k, shape in RESTORE_SHAPES.items()}

    # a dim over both axes: rank (d, m) holds JAX's chunk d x 2 + m
    two_axis = distribute_params({"x": torch.arange(8.0)},
                               {"x": Sharding(mesh, Spec(("data", "model")))})["x"]
    tree = restore_tree()
    ckpt = CheckpointManager(ckpt_dir)
    ckpt.save(3, distribute_params(tree, layout(mesh, ("data", "model"))))
    swapped = ckpt.restore(3, tree, shardings=layout(mesh, ("model", "data")))
    one_d = ckpt.restore(3, tree, shardings=layout(flat, ("data", None)))
    return {"pipeline": got.detach(), "stage_grad": grad[rank],
            "coordinate": tuple(mesh.get_coordinate()), "two_axis": two_axis.to_local(),
            "swapped": _full(swapped), "one_d": _full(one_d),
            "placements": {k: (str(swapped[k].placements), str(one_d[k].placements))
                           for k in tree}}


GQA_HEADS = dict(n_heads=16, n_kv_heads=2)   # 16 query heads (sharded), 2 kv heads
GQA_ARCHS = ("qwen3-0.6b", "mixtral-8x7b")
GQA_DECODE_TOKENS = 6


def gqa_cfg(arch: str):
    """The reduced float64 config of a GQA case: 16 query heads, which the
    rules shard over "model" (16 divides the production axis), against 2 kv
    heads, which 4 model ranks do not divide."""
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced(dtype="float64", **GQA_HEADS)


def gqa_ranks(world_size: int) -> dict:
    """The uneven GQA split with numbers: each GQA case on a (1, 4) mesh,
    two training steps of ``build_train_step`` (``policy="tp"``), the last
    logits of ``build_prefill_step`` and GQA_DECODE_TOKENS steps of
    ``build_serve_step`` (every step's logits, the final state), and the
    placements its query and kv projections took."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Knobs, decode_state_specs, init_model
    from repro_torch.optim import adam_init

    mesh = make_debug_mesh(1, 4, "cpu")
    knobs = Knobs(q_chunk=SHARD_CHUNKS[0], kv_chunk=SHARD_CHUNKS[1])
    out = {}
    for arch in GQA_ARCHS:
        cfg = gqa_cfg(arch)
        params = init_model(cfg, 0, device="cpu")
        batches = [synthetic_batch(cfg, ShapeCfg("b", SHARD_S, SHARD_B, "train"), i,
                                   dtype=F64, device="cpu") for i in range(2)]
        rec = {}
        with lifted_islands():
            built = sharding.build_train_step(cfg, mesh, ShapeCfg("t", SHARD_S, SHARD_B, "train"),
                                              knobs=knobs, policy="tp")
            p, o, losses = params, adam_init(params), []
            for b in batches:
                p, o, loss, _ = built.fn(p, o, b)
                losses.append(float(loss.full_tensor()))
            attn = p["stack"]["groups"]["layers"][0]["attn"]
            rec.update(losses=losses, params=_full(p),
                       placements={k: str(attn[k].placements) for k in ("wq", "wk")})
            prefill = sharding.build_prefill_step(cfg, mesh, ShapeCfg("p", SHARD_S, SHARD_B,
                                                                      "prefill"), knobs=knobs)
            rec["prefill"] = prefill.fn(params, batches[0]).full_tensor()
            serve = sharding.build_serve_step(cfg, mesh, ShapeCfg("d", SHARD_S, SHARD_B,
                                                                  "decode"), knobs=knobs)
            st, logits = decode_state_specs(cfg, SHARD_B, SHARD_S, device="cpu"), []
            for i in range(GQA_DECODE_TOKENS):
                lg, st = serve.fn(params, batches[0]["tokens"][:, i:i + 1], st)
                logits.append(lg.full_tensor())
            rec.update(logits=torch.stack(logits), state=_full(st))
        out[arch] = rec
    return out


def _dense_case(mesh, x, w, x_placements) -> dict:
    """``sharding_rules.dense`` of ``x`` laid out by ``x_placements``
    against ``w`` row-sharded over "model", under ``OpCounter``: the
    output's placements, each local product's contracted size, the
    collectives the product moved, and the output gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.op_static import OpCounter
    from repro_torch.models.sharding_rules import dense, make_rules, use_rules
    xd = distribute_tensor(x, mesh, x_placements)
    wd = distribute_tensor(w, mesh, (Replicate(), Shard(0)))
    with use_rules(make_rules(mesh)), OpCounter(mesh) as counter:
        y = dense(xd, wd)
    ks = [flops * x.element_size() // (2 * res) for op, flops, res, *_ in counter.log()
          if op == "aten.mm"]
    return {"placements": str(tuple(y.placements)), "k": ks,
            "collectives": dict(counter.totals.collective_bytes), "y": y.full_tensor()}


MOE_CASE = dict(batch=4, seq=64)   # 256 tokens: 32 groups of 8, capacity 1 in training


def _moe_run(cfg, params, x, c, training: bool):
    """``apply_moe`` of ``x`` and the gradients of (y * c).sum() + aux with
    respect to ``x`` and every parameter leaf, gathered."""
    from repro_torch.models import moe
    from repro_torch.tree import leaves
    y, aux = moe.apply_moe(params, cfg, x, training=training)
    loss = (y * c).sum() + aux
    grads = torch.autograd.grad(loss, [x] + leaves(params))
    full = [(t.full_tensor() if hasattr(t, "full_tensor") else t).detach() for t in [y, aux, *grads]]
    return {"y": full[0], "aux": full[1], "grads": full[2:]}


def sharding_faults(world_size: int) -> dict:
    """On a (1, 4) ("data", "model") mesh: ``dense`` of a replicated and of
    a K-sharded activation against a row-sharded weight (``_dense_case``),
    and reduced llama4's MoE layer with 16 experts (expert parallel: 4 a
    rank) in inference and in training (capacity 1 binds), its output and
    gradients against the unsharded layer's and the dispatch buffer's
    local expert count, float64 with the islands lifted."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (Sharding, _model_context, bind_param_shardings,
                                             distribute_params, place)
    from repro_torch.models import moe
    from repro_torch.models.layers import Maker
    from repro_torch.models.sharding_rules import Spec, make_rules

    mesh = make_debug_mesh(1, world_size, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4 * world_size)))
    w = torch.from_numpy(rng.normal(size=(4 * world_size, 5)))
    out = {"want": x @ w,
           "replicated": _dense_case(mesh, x, w, (Replicate(), Replicate())),
           "split": _dense_case(mesh, x, w, (Replicate(), Shard(2)))}

    cfg = shard_cfg("llama4-maverick-400b-a17b")
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(Maker(gen, F64, "cpu"), cfg)
    specs = moe.init_moe(Maker(None, F64, "meta", specs=True), cfg)
    rules = make_rules(mesh)
    shardings = bind_param_shardings(mesh, specs, params, rules)
    b, s = MOE_CASE["batch"], MOE_CASE["seq"]
    xm = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)))
    c = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)))
    buffers = []
    dispatch = moe._dispatch

    def recorded(*args):
        res = dispatch(*args)
        buffers.append(tuple(res[0].shape))
        return res

    moe._dispatch = recorded
    try:
        with lifted_islands():
            for training in (False, True):
                plain = _moe_run(cfg, {k: v.clone().requires_grad_() for k, v in params.items()},
                                 xm.clone().requires_grad_(), c, training)
                with _model_context(rules):
                    pd = {k: v.detach().requires_grad_() for k, v in
                          distribute_params(params, shardings).items()}
                    xd = place(xm, Sharding(mesh, Spec("data"))).requires_grad_()
                    cd = place(c, Sharding(mesh, Spec("data")))
                    sharded = _moe_run(cfg, pd, xd, cd, training)
                out[f"moe_{'train' if training else 'infer'}"] = {"plain": plain,
                                                                    "sharded": sharded}
    finally:
        moe._dispatch = dispatch
    out["moe_buffers"] = buffers
    return out


# the dry run's scenarios: each opens its own fake process group
FAKE_GROUP = ("dryrun_cells", "dryrun_small_mesh", "fake_collectives")


def dryrun_cells(world_size: int, cells, trace_dir=None) -> dict:
    """Production cells of ``launch.dryrun``, ``(arch, shape, mesh,
    layers)`` each, on the CPU: {"arch/shape/mesh": its record}; with
    ``trace_dir``, each cell's op log is kept there (``--trace-dir``)."""
    from repro_torch.launch import dryrun
    return {f"{a}/{s}/{m}": dryrun.run_cell(a, s, m, device="cpu", layers=n, verbose=False,
                                            trace_dir=trace_dir)
            for a, s, m, n in cells}


def dryrun_small_mesh(world_size: int) -> dict:
    """The reference's small-mesh dry-run cell: reduced granite trained at
    ShapeCfg("t", 64, 8) with FSDP on a fake (2, 2, 2) ("pod", "data",
    "model") mesh, counted by ``dryrun.count_step``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun, sharding
    from torch.distributed.device_mesh import init_device_mesh

    dryrun.fake_process_group(8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    built = sharding.build_train_step(get_arch("granite-3-2b").reduced(), mesh,
                                      ShapeCfg("t", 64, 8, "train"), fsdp=True)
    totals, _ = dryrun.count_step(built, mesh, "cpu")
    return {"flops": totals.flops, "bytes": totals.bytes,
            "collective_bytes": totals.total_collective_bytes, "peak": totals.peak_bytes}


def fake_collectives(world_size: int) -> dict:
    """On fake process groups: an all-gather of a (3, 5) float32 shard over
    4 ranks under ``OpCounter`` (its result bytes and mesh dim), then a
    (4096, 2048) x (2048, 8192) product of DTensors on a 16 x 16 mesh under
    fake tensors (the local FLOPs alone)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import dryrun
    from repro_torch.launch.op_static import OpCounter

    dryrun.fake_process_group(4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    with OpCounter(mesh) as counter:
        funcol.all_gather_single(torch.zeros(3, 5), 0, (mesh, 0)).wait()
    out = {"gather": counter.totals}
    dryrun.fake_process_group(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        a = distribute_tensor(torch.empty(4096, 2048), mesh, (Shard(0), Replicate()))
        b = distribute_tensor(torch.empty(2048, 8192), mesh, (Replicate(), Shard(1)))
        with OpCounter(mesh) as counter:
            a @ b
    del mode
    out["matmul"] = counter.totals
    return out


SCENARIOS = {"everything": everything, "pinn_loss_parity": pinn_loss_parity,
             "train_parity": train_parity, "serving_idle": serving_idle,
             "sharding_train": sharding_train, "sharding_serve": sharding_serve,
             "pipeline_restore": pipeline_restore, "gqa_ranks": gqa_ranks,
             "sharding_faults": sharding_faults,
             "dryrun_cells": dryrun_cells, "dryrun_small_mesh": dryrun_small_mesh,
             "fake_collectives": fake_collectives}
