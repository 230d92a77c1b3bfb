"""The port's LM models against the JAX package's (``tests/_torch_lm.py``
holds the harness, its modes and why its tolerances are what they are):
qwen3 (GQA, qk_norm), granite (full attention, scan groups of 2) and
gemma3 (5 local : 1 global) at their reduced configs; the decode state's
layout; the families still to port, which raise; and ``blocked_attention``'s
global (online softmax) branch against ``full_attention``.
``tests/test_torch_models_families.py`` holds gemma2, the VLM and the
encoder-decoder."""

import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H
from repro.models import decode_state_specs as jdecode_state_specs
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.models import decode_state_specs, forward_seq, init_model

ARCHS = ("qwen3-0.6b", "granite-3-2b", "gemma3-4b")
CASES = [(arch, mode) for arch in ARCHS for mode in H.MODES] + [("qwen3-0.6b",
                                                                 "float64-islands")]
WAITING = tuple(a for a in ASSIGNED if a not in H.PORTED)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_the_reference_tree(arch):
    H.init_builds_the_reference_tree(arch)


@pytest.mark.parametrize("arch", WAITING)
def test_unported_families_raise(arch):
    """MoE, Mamba2, RWKV6 and the hybrid shared block wait for ROADMAP
    Queue 1 item 6b: every entry point says so, none skips the layers."""
    cfg = get_arch(arch).reduced()
    for call in (lambda: init_model(cfg, 0, device="cpu"),
                 lambda: decode_state_specs(cfg, H.B, H.S, device="cpu"),
                 lambda: forward_seq({}, cfg, {})):
        with pytest.raises(NotImplementedError, match="item 6b"):
            call()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_decode_state_specs_matches_the_reference_layout(arch):
    jcfg, cfg = H.cfgs(arch, "float32")
    ref = H.as_numpy(jdecode_state_specs(jcfg, H.B, H.S, abstract=False))
    st = decode_state_specs(cfg, H.B, H.S, device="cpu")
    assert sorted(st) == sorted(ref)
    assert int(st["pos"]) == int(ref["pos"]) == H.S - 1
    for key in ("kv", "cross_kv"):
        if key in ref:
            for got, want in zip(st[key], ref[key]):
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32
                assert not got.any()


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_forward_seq_matches_reference(case):
    H.forward_seq_matches_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_train_loss_and_gradient_match_reference(case):
    H.train_loss_and_gradient_match_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_prefill_and_decode_match_reference(case):
    H.prefill_and_decode_match_reference(*case)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-4b"])
def test_prefill_then_decode_is_the_full_forward(arch):
    H.prefill_then_decode_is_the_full_forward(arch)


@pytest.mark.parametrize("mode", H.MODES)
def test_blocked_attention_global_branch_matches_full_attention(mode):
    """qwen3's first layer, query chunks of 16 against key chunks of 32."""
    H.blocked_attention_matches_full_attention("qwen3-0.6b", None, 16, 32, mode)
