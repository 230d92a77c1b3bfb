"""The port's examples (``examples/torch_*.py``), driven in process through
their ``main(argv)`` on the CPU at a few steps and narrow widths.

* quickstart: the derivatives through order 4 against nested autodiff;
* burgers_profile: a few Adam and L-BFGS steps, lambda kept in its window;
* pde_operator: one process, and ``--devices 1`` under a world-size-1 gloo
  group on a ``FileStore`` (bit for bit with the run without a mesh);
  ``--devices 2`` without a group is refused with the torchrun advice;
* serve_operator: train -> checkpoint -> serve for every engine spec, each
  served table against a direct call within 1e-12 and the specs against
  each other within 1e-9;
* serve_lm: reduced gemma3 prefilled and decoded, greedy; reduced zamba2
  and rwkv6 warmed step by step (``prefill`` never called), then decoded;
* sobolev_lm: a few steps of CE + the order-3 jet penalty on reduced qwen3;
* each refuses to run without the card unless told ``--device cpu``.
"""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from repro_torch.tree import bit_equal

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_burgers_profile", "torch_pde_operator",
         "torch_serve_operator", "torch_serve_lm", "torch_sobolev_lm")
TOL_DIRECT = 1e-12
TOL_SPECS = 1e-9


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_nested_autodiff():
    out = _example("torch_quickstart").main(["--device", "cpu", "--order", "4"])
    assert out["derivs"].shape == (5, 256, 1) and out["autodiff_err"] < 1e-12


def test_burgers_profile_runs_a_few_steps():
    out = _example("torch_burgers_profile").main(
        ["--k", "1", "--adam", "3", "--lbfgs", "2", "--width", "8", "--depth", "2",
         "--device", "cpu"])
    res = out["result"]
    assert 1 / 3 < res.lam < 1.0 and math.isfinite(out["l2_error"])
    assert all(math.isfinite(v) for v in res.loss_history)


PDE = ["--op", "heat", "--steps", "3", "--lbfgs", "1", "--width", "8", "--depth", "2",
       "--points", "64", "--device", "cpu"]


def test_pde_operator_one_process_and_under_a_world_size_one_group(tmp_path):
    ex = _example("torch_pde_operator")
    one = ex.main(PDE)
    assert one["data_parallel"] == 0 and one["result"].loss_history[-1] < \
        one["result"].loss_history[0]
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        dp = ex.main(PDE + ["--devices", "1"])
    finally:
        dist.destroy_process_group()
    assert dp["data_parallel"] == 1
    a, b = one["result"], dp["result"]
    assert bit_equal(torch.tensor(a.loss_history), torch.tensor(b.loss_history))
    assert bit_equal(a.params, b.params)


def test_pde_operator_refuses_devices_without_a_process_group():
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        _example("torch_pde_operator").main(PDE + ["--devices", "2"])


def test_serve_operator_every_spec_agrees_with_direct_calls(tmp_path):
    ex = _example("torch_serve_operator")
    out = ex.main(["--steps", "3", "--width", "8", "--depth", "2", "--clients", "2",
                   "--points", "6", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "step_0000000003" / "manifest.json").exists()
    ref = out["ntp"]["tables"]
    for spec in ex.SPECS:
        s = out[spec]
        assert s["worst"] <= TOL_DIRECT and s["metrics"]["requests"] == 3, spec
        for got, want in zip(s["tables"], ref):
            assert got.shape == want.shape == (2, 3, 6, 1)
            assert float((got - want).abs().max()) <= TOL_SPECS * float(want.abs().max())


def test_serve_lm_prefills_and_decodes_gemma3():
    out = _example("torch_serve_lm").main(["--arch", "gemma3-4b", "--batch", "2",
                                           "--prompt-len", "12", "--gen", "4",
                                           "--device", "cpu"])
    assert out["tokens"].shape == (2, 4) and out["ms_per_token"] > 0


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_serve_lm_warms_the_recurrent_archs_step_by_step(arch, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "prefill", lambda *a, **k: pytest.fail("prefill called"))
    out = _example("torch_serve_lm").main(["--arch", arch, "--batch", "2",
                                           "--prompt-len", "6", "--gen", "3",
                                           "--device", "cpu"])
    assert out["tokens"].shape == (2, 3) and out["prefill_ms"] > 0


def test_sobolev_lm_trains_with_the_jet_penalty():
    out = _example("torch_sobolev_lm").main(["--steps", "3", "--batch", "2", "--seq", "16",
                                             "--device", "cpu"])
    assert len(out["ce"]) == len(out["smooth"]) == 3
    assert all(math.isfinite(c) and c > 0 for c in out["ce"])
    assert all(math.isfinite(s) and s > 0 for s in out["smooth"])


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_the_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
