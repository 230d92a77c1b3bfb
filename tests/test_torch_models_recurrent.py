"""The port's recurrent LM archs against the JAX package's
(``tests/_torch_lm.py`` holds the harness, its modes and why its tolerances
are what they are): rwkv6 (RWKV-6 time mix through the GLA engine's
per-channel decay, the channel mix's token shift) and zamba2 (Mamba2
blocks through its scalar decay, the tied shared attention block after
each group) at their reduced configs.  Neither builds a cache in
``prefill``: both decode token by token from ``decode_state_specs``, every
step's logits and every state leaf held to the reference's (the state's
layout is in ``tests/test_torch_models.py``).
``tests/test_torch_models_moe.py`` holds the MoE archs."""

import pytest

torch = pytest.importorskip("torch")

import _torch_lm as H

ARCHS = H.RECURRENT
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
def test_stepwise_decode_matches_reference(case):
    H.stepwise_decode_matches_reference(*case)


@pytest.mark.parametrize("arch", ARCHS)
def test_stepwise_decode_is_the_chunked_forward(arch):
    H.stepwise_decode_is_the_chunked_forward(arch)
