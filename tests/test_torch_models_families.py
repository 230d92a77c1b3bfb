"""The port's LM models against the JAX package's (``tests/_torch_lm.py``
holds the harness, its modes and why its tolerances are what they are):
gemma2 (local/global alternation, attention and logit softcaps, GeGLU),
llava (the VLM stub: patch embeddings through a projector, fused in front
of the tokens) and whisper (the encoder-decoder: an encoder stack on
frames, cross-attention and its caches) at their reduced configs, and
``blocked_attention``'s local (exact span) branch against
``full_attention``.  ``tests/test_torch_models.py`` holds the other three
ported archs."""

import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H

ARCHS = ("gemma2-27b", "llava-next-mistral-7b", "whisper-large-v3")
CASES = [(arch, mode) for arch in ARCHS for mode in H.MODES]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_the_reference_tree(arch):
    H.init_builds_the_reference_tree(arch)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_forward_seq_matches_reference(case):
    H.forward_seq_matches_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_train_loss_and_gradient_match_reference(case):
    H.train_loss_and_gradient_match_reference(*case)


@pytest.mark.parametrize("case", CASES, ids=H.case_id)
def test_prefill_and_decode_match_reference(case):
    H.prefill_and_decode_match_reference(*case)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_prefill_then_decode_is_the_full_forward(arch):
    H.prefill_then_decode_is_the_full_forward(arch)


@pytest.mark.parametrize("mode", H.MODES)
def test_blocked_attention_local_branch_matches_full_attention(mode):
    """gemma2's first (local) layer at window 8, query and key chunks of 16:
    the exact-span branch."""
    H.blocked_attention_matches_full_attention("gemma2-27b", 8, 16, 16, mode)
