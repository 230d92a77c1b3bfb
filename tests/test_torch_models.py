"""The port's LM models against the JAX package's (``tests/_torch_lm.py``
holds the harness, its modes and why its tolerances are what they are):
qwen3 (GQA, qk_norm), granite (full attention, scan groups of 2) and
gemma3 (5 local : 1 global) at their reduced configs; the decode state's
layout; the families that raised until they were ported (now built and run
by every entry point, held to the reference in
``tests/test_torch_models_{recurrent,moe}.py``); and ``blocked_attention``'s
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
# the families that waited for ROADMAP Queue 1 item 6b
WAITED = ("mixtral-8x7b", "llama4-maverick-400b-a17b", "zamba2-2.7b", "rwkv6-3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_the_reference_tree(arch):
    H.init_builds_the_reference_tree(arch)


def test_every_assigned_lm_arch_is_ported():
    assert set(ASSIGNED) - {"pinn-mlp", "pinn-pde"} == set(H.PORTED)


@pytest.mark.parametrize("arch", WAITED)
def test_unported_families_raise(arch):
    """MoE, Mamba2, RWKV6 and the hybrid shared block raised
    ``NotImplementedError`` from every entry point until ROADMAP Queue 1
    item 6b; now none raises: init builds every layer, the decode state
    holds the family's entries, and the forward runs them all (finite
    hidden states; a MoE arch's balance loss above 0)."""
    cfg = get_arch(arch).reduced()
    params = init_model(cfg, 0, device="cpu")
    st = decode_state_specs(cfg, H.B, H.S, device="cpu")
    want = {"mixtral-8x7b": {"kv"}, "llama4-maverick-400b-a17b": {"kv"},
            "zamba2-2.7b": {"mamba", "shared_kv"}, "rwkv6-3b": {"rwkv"}}[arch]
    assert set(st) == want | {"pos"}
    with torch.no_grad():
        x, aux, _, _ = forward_seq(params, cfg, H.tbatch(H.make_batch(cfg)))
    assert x.shape == (H.B, H.S, cfg.d_model) and bool(torch.isfinite(x).all())
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_decode_state_specs_matches_the_reference_layout(arch):
    """The same entries and leaves, zeroed, float32: the KV caches in the
    reduced model's dtype, the recurrent states as the reference keeps them
    whatever the model's dtype, zamba2's shared caches one per group."""
    jcfg, cfg = H.cfgs(arch, "float32")
    ref = H.state_leaves("st", H.as_numpy(jdecode_state_specs(jcfg, H.B, H.S,
                                                               abstract=False)))
    got = H.state_leaves("st", decode_state_specs(cfg, H.B, H.S, device="cpu"))
    assert sorted(got) == sorted(ref)
    assert int(got["st pos"]) == int(ref["st pos"]) == H.S - 1
    for name, want in ref.items():
        if name != "st pos":
            leaf = got[name]
            assert tuple(leaf.shape) == want.shape and leaf.dtype == torch.float32, name
            assert not leaf.any(), name


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
