"""The port's LM launchers on the CPU: ``launch/serve.py`` (the reference's
CLI cases of ``tests/test_serving.py``, and ``run``; the recurrent archs'
step-wise warm-up against the reference's serving loop), the synthetic
token pipeline (``data/tokens.py``), and ``launch/train.py``'s ``run``
under the fault-tolerant ``Trainer`` with the jet regularizer on: an
injected failure restores the last checkpoint bit for bit and the run ends
where an uninterrupted one does; a MoE arch's balance loss reaches the
loss and the run's metrics."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.tokens import batch_stream, synthetic_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import VLM_EMBED_DIM
from repro_torch.tree import bit_equal

# ---------------------------------------------------------------------------
# launch/serve.py: the reference's CLI regressions
# ---------------------------------------------------------------------------


def test_serve_cli_flags_can_be_disabled():
    args = serve_cli.parse_args([])
    assert args.reduced is True and args.greedy is True and args.device == "cuda"
    args = serve_cli.parse_args(["--no-reduced", "--no-greedy", "--device", "cpu"])
    assert args.reduced is False and args.greedy is False and args.device == "cpu"


@pytest.mark.parametrize("flag", ["--prompt-len", "--gen"])
def test_serve_cli_rejects_empty_prompt_and_generation(flag):
    with pytest.raises(SystemExit):
        serve_cli.parse_args([flag, "0"])


def test_serve_cli_select_token_consumes_greedy():
    logits = torch.tensor([[0.0, 10.0, 0.0], [5.0, 0.0, 0.0]])
    tok = serve_cli.select_token(logits, greedy=True)
    assert tok.shape == (2, 1) and tok.dtype == torch.int64
    assert tok.tolist() == [[1], [0]]
    # sampling path: sharp logits make the sample deterministic, proving
    # the flag reaches the decode rule
    sampled = serve_cli.select_token(1e6 * logits, greedy=False,
                                     generator=torch.Generator().manual_seed(0))
    assert sampled.tolist() == [[1], [0]]
    with pytest.raises(ValueError):
        serve_cli.select_token(logits, greedy=False)   # no generator


@pytest.mark.parametrize("greedy", [True, False])
def test_serve_run_is_deterministic(greedy):
    cfg = get_arch("gemma3-4b").reduced()
    a = serve_cli.run(cfg, 2, 8, 5, greedy=greedy, sample_seed=3, device="cpu")
    b = serve_cli.run(cfg, 2, 8, 5, greedy=greedy, sample_seed=3, device="cpu")
    assert a["tokens"].shape == (2, 5) and torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert a["prefill_ms"] > 0 and a["decode_ms"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_serve_warms_a_recurrent_state_step_by_step(arch, monkeypatch):
    """A recurrent arch builds no cache in ``prefill``: ``run`` warms its
    state token by token from ``decode_state_specs`` and never calls
    ``prefill``.  Its greedy tokens are the reference's serving loop's
    (``repro/launch/serve.py``: the same warm-up, then decode) on the same
    parameters and prompts, at float64 with both packages' float32 islands
    lifted, so near-tied logits cannot part the two argmaxes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import _torch_lm as H
    from repro.models import decode_state_specs as jdecode_state_specs
    from repro.models import decode_step as jdecode_step
    from repro_torch import bridge

    bsz, prompt_len, gen = 2, 8, 5
    jcfg, cfg = H.cfgs(arch, "float64")
    params, _ = H.reference(arch, "float64")
    monkeypatch.setattr(serve_cli, "prefill", lambda *a, **k: pytest.fail("prefill called"))
    prompts = synthetic_batch(cfg, ShapeCfg("serve", prompt_len, bsz, "prefill"), 0,
                              device="cpu")["tokens"]
    with H.islands("float64"):
        got = serve_cli.run(cfg, bsz, prompt_len, gen, params=bridge.params_from_numpy(
            params, device="cpu"), device="cpu")
        st = H.lift_state(jdecode_state_specs(jcfg, bsz, prompt_len + gen, abstract=False),
                          "float64")
        st["pos"] = jnp.asarray(0, jnp.int32)
        step = jax.jit(lambda p, t, s: jdecode_step(p, jcfg, t, s))
        toks = jnp.asarray(prompts.numpy(), jnp.int32)
        for t in range(prompt_len):
            lg, st = step(params, toks[:, t:t + 1], st)
        want = []
        for _ in range(gen):
            tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
            want.append(np.asarray(tok))
            lg, st = step(params, tok, st)
    assert got["tokens"].tolist() == np.concatenate(want, 1).tolist()
    assert got["prefill_ms"] > 0 and got["decode_ms"] > 0


def test_serve_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main([])


# ---------------------------------------------------------------------------
# data/tokens.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llava-next-mistral-7b", "whisper-large-v3"])
def test_synthetic_batch_is_deterministic_per_step_and_in_range(arch):
    cfg = get_arch(arch).reduced()
    shape = ShapeCfg("t", 24, 3, "train")
    a = synthetic_batch(cfg, shape, 5, device="cpu")
    b = synthetic_batch(cfg, shape, 5, device="cpu")
    c = synthetic_batch(cfg, shape, 6, device="cpu")
    assert sorted(a) == sorted(b) and all(bit_equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    toks = a["tokens"]
    assert toks.dtype == torch.int64
    assert toks.shape == (3, 24 - cfg.vlm_image_tokens)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    if cfg.encoder is not None:
        assert a["frames"].shape == (3, cfg.encoder.seq, cfg.d_model)
    if cfg.vlm_image_tokens:
        assert a["image_embeds"].shape == (3, cfg.vlm_image_tokens, VLM_EMBED_DIM)
    # a host slice is its own draw from the row offset
    part = synthetic_batch(cfg, shape, 5, batch_slice=slice(1, 3), device="cpu")
    assert part["tokens"].shape[0] == 2


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
@pytest.mark.parametrize("start", [0, 7])
def test_batch_stream_yields_the_steps_batches(arch, start):
    """The stream's n-th batch is ``synthetic_batch`` of step start + n,
    bit for bit (the reference's ``batch_stream``)."""
    cfg = get_arch(arch).reduced()
    shape = ShapeCfg("t", 16, 2, "train")
    stream = batch_stream(cfg, shape, start, dtype=torch.float64, device="cpu")
    for n in range(3):
        got = next(stream)
        want = synthetic_batch(cfg, shape, start + n, dtype=torch.float64, device="cpu")
        assert sorted(got) == sorted(want) and all(bit_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

TRAIN_SHAPE = ShapeCfg("custom", 16, 2, "train")


def _fail_once(at):
    left = {at}

    def injector(step):
        if step in left:
            left.clear()
            raise RuntimeError(f"injected failure at step {step}")

    return injector


def test_train_run_restores_after_a_failure_bit_for_bit(tmp_path):
    """Reduced qwen3, 6 steps, the order-2 jet penalty on, a checkpoint
    every 3 steps.  A failure at step 4 restores step 3 (one restart: step 3
    runs again) and the run ends on the uninterrupted run's state, bit for
    bit; both runs wrote the same step-3 checkpoint."""
    cfg = get_arch("qwen3-0.6b").reduced()
    clean = train_cli.run(cfg, TRAIN_SHAPE, 6, 1e-3, ntp_order=2,
                          ckpt_dir=str(tmp_path / "clean"), ckpt_every=3, device="cpu")
    failed = train_cli.run(cfg, TRAIN_SHAPE, 6, 1e-3, ntp_order=2,
                           ckpt_dir=str(tmp_path / "failed"), ckpt_every=3, device="cpu",
                           fail_injector=_fail_once(4))
    rep = failed["report"]
    assert clean["report"].restarts == 0 and rep.restarts == 1
    assert rep.steps_run == 6 + 1      # step 3 runs again (step 4 failed before it ran)
    assert bit_equal((failed["params"], failed["opt"]), (clean["params"], clean["opt"]))
    like = (clean["params"], clean["opt"])
    assert bit_equal(CheckpointManager(str(tmp_path / "failed")).restore(3, like),
                     CheckpointManager(str(tmp_path / "clean")).restore(3, like))
    assert int(failed["opt"].step) == 6
    for out in (clean, failed):
        assert len(out["ce"]) == len(out["smooth"]) == len(out["step_ms"]) == \
            out["report"].steps_run
        assert all(c > 0 for c in out["ce"]) and all(s > 0 for s in out["smooth"])
    # the re-run steps give the losses they gave the first time
    assert rep.losses == clean["report"].losses[:4] + clean["report"].losses[3:]


def test_train_run_carries_the_moe_balance_loss(tmp_path):
    """Reduced mixtral, 2 steps: each step's loss is its cross-entropy
    plus ``Knobs.aux_coef`` x the balance loss, which ``run`` reports (about
    1 a MoE layer for near-uniform routing)."""
    from repro_torch.models import Knobs

    cfg = get_arch("mixtral-8x7b").reduced()
    out = train_cli.run(cfg, TRAIN_SHAPE, 2, 1e-2, ckpt_dir=str(tmp_path), device="cpu")
    rep = out["report"]
    assert rep.steps_run == 2 and len(out["aux"]) == 2
    for loss, ce, aux in zip(rep.losses, out["ce"], out["aux"]):
        assert 0.5 * cfg.n_layers < aux < 2.0 * cfg.n_layers
        assert math.isclose(loss, ce + Knobs().aux_coef * aux, rel_tol=1e-6)
    # a dense arch's balance loss is 0
    dense = train_cli.run(dataclasses.replace(get_arch("qwen3-0.6b").reduced(), n_layers=1),
                          TRAIN_SHAPE, 1, ckpt_dir=str(tmp_path / "dense"), device="cpu")
    assert dense["aux"] == [0.0] and dense["report"].losses == dense["ce"]


def test_train_main_needs_the_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_decode_step_leaves_its_state_as_it_was():
    """decode_step writes the new token into a copy of the caches: the
    state it was given decodes again to the same logits and caches."""
    from repro_torch.models import decode_step, init_model, prefill

    cfg = get_arch("gemma3-4b").reduced()
    params = init_model(cfg, 0, device="cpu")
    batch = synthetic_batch(cfg, ShapeCfg("t", 20, 2, "prefill"), 0, device="cpu")
    with torch.no_grad():
        _, st = prefill(params, cfg, batch, pad_to=24)
        before = {k: v.clone() for k, v in zip("kv", st["kv"])}
        tok = batch["tokens"][:, -1:]
        a, st_a = decode_step(params, cfg, tok, st)
        b, st_b = decode_step(params, cfg, tok, st)
    assert torch.equal(st["kv"].k, before["k"]) and torch.equal(st["kv"].v, before["v"])
    assert torch.equal(a, b) and torch.equal(st_a["kv"].k, st_b["kv"].k)
    assert not torch.equal(st_a["kv"].k, st["kv"].k)
    assert int(st_a["pos"]) == int(st["pos"]) + 1
