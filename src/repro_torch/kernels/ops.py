"""Public dispatch for the jet kernels.

:func:`jet_dense` and :func:`act_jet` (the dense path),
:func:`jet_rms_norm` and :func:`jet_flash_attention` (the transformer
trunk) and :func:`jet_attention_scores` (the materializing score jet)
launch the hand-written CUDA kernels for CUDA tensors and run their
plain versions (kernels/ref.py) only for CPU tensors, so the CPU tests
reach every line around the kernels.  There is no
fallback: on the card a wrapper launches its kernel or raises.  Every
order and float32, float64 and bfloat16 (computed in float32) are taken
on both devices; on the card a launch is refused only where its block
does not fit in shared memory.

* All accept **arbitrary leading batch axes** -- ``(n+1, *batch, D)`` --
  and fold them into the kernel's batch dimension (a free reshape).
* :func:`epilogues` is the typed capability registry: fusable name ->
  :class:`EpilogueKind`.  ``ACTIVATION`` entries are the closed-form tables
  the dense kernel's epilogue can run; ``FUSED_OP`` entries
  (``"rms_norm"``, ``"attention_scores"``, ``"flash_attention"``) are
  whole-chain kernels with their own dispatch function.
* The wrappers are ``torch.autograd.Function``s whose backward recomputes
  through the plain version, as the reference's ``custom_vjp``s do: the
  residuals are just the layer inputs, so activation memory stays O(n M).
"""

from __future__ import annotations

import enum
from types import MappingProxyType
from typing import Mapping

import torch

from . import jet_attention as _k34
from . import jet_dense as _k1
from . import ref
from . import tanh_jet as _k2
from .tanh_jet import KERNEL_ACTS

__all__ = ["EpilogueKind", "epilogues", "act_jet", "jet_dense",
           "jet_rms_norm", "jet_flash_attention", "jet_attention_scores",
           "launch_counts", "reset_launch_counts"]


class EpilogueKind(enum.Enum):
    """What a fusable-name entry in :func:`epilogues` is capable of.

    ``ACTIVATION``
        a closed-form Taylor table the *dense kernel* can evaluate in its
        Faa di Bruno epilogue (also valid standalone via ``act_jet``);
    ``FUSED_OP``
        a dedicated whole-chain kernel reached through its own dispatch
        function -- never a dense epilogue.
    """

    ACTIVATION = "activation"
    FUSED_OP = "fused_op"


_EPILOGUE_KINDS: dict = {
    **{a: EpilogueKind.ACTIVATION for a in KERNEL_ACTS},
    "rms_norm": EpilogueKind.FUSED_OP,
    "attention_scores": EpilogueKind.FUSED_OP,
    "flash_attention": EpilogueKind.FUSED_OP,
}
_COUNTERS = (_k1.LAUNCHES, _k2.LAUNCHES, _k34.RMS_NORM_LAUNCHES,
             _k34.FLASH_LAUNCHES, _k34.SCORES_LAUNCHES)


def epilogues() -> Mapping[str, EpilogueKind]:
    """The capability registry: fusable name -> :class:`EpilogueKind`,
    read-only."""
    return MappingProxyType(_EPILOGUE_KINDS)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {c.name: c.count for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()


def _fold_batch(coeffs: torch.Tensor, keep: int = 1) -> tuple[torch.Tensor, tuple]:
    """(n+1, *batch, *trailing) -> ((n+1, prod(batch), *trailing), batch),
    preserving the last ``keep`` axes.  The inverse is a plain reshape of
    the kernel output."""
    batch = tuple(coeffs.shape[1:-keep])
    flat = 1
    for s in batch:
        flat *= s
    return coeffs.reshape(tuple(coeffs.shape[:1]) + (flat,)
                          + tuple(coeffs.shape[-keep:])), batch


def _check_activation(activation: str | None, allow_none: bool) -> None:
    if activation is None and allow_none:
        return
    if activation not in KERNEL_ACTS:
        raise ValueError(
            f"no kernel epilogue for activation {activation!r}; the kernels "
            f"take {KERNEL_ACTS}" + (" or None" if allow_none else "")
            + " (route others through jet_dense(..., None) and the jet algebra)")


def _check_stack(coeffs: torch.Tensor) -> None:
    if coeffs.ndim < 2 or coeffs.shape[0] < 1:
        raise ValueError(f"a jet stack is (n+1, ..., D) with n >= 0, got shape "
                         f"{tuple(coeffs.shape)}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"the jet kernels run on CUDA tensors (plain version on "
                     f"CPU tensors), got a tensor on {t.device}")


def _act_jet_impl(coeffs: torch.Tensor, activation: str) -> torch.Tensor:
    if _on_cpu(coeffs):
        return ref.act_jet_ref(coeffs, activation)
    return _k2.act_jet_cuda(coeffs, activation)


def _jet_dense_impl(coeffs, w, b, activation):
    if _on_cpu(coeffs):
        return ref.jet_dense_ref(coeffs, w, b, activation)
    return _k1.jet_dense_cuda(coeffs, w, b, activation)


class _ActJet(torch.autograd.Function):
    """Forward: the kernel (plain version on CPU).  Backward: a recompute
    through the plain version."""

    @staticmethod
    def forward(ctx, coeffs, activation):
        ctx.activation = activation
        ctx.save_for_backward(coeffs)
        return _act_jet_impl(coeffs, activation)

    @staticmethod
    def backward(ctx, g):
        (coeffs,) = ctx.saved_tensors
        with torch.enable_grad():
            c = coeffs.detach().requires_grad_()
            out = ref.act_jet_ref(c, ctx.activation)
        (gc,) = torch.autograd.grad(out, c, g)
        return gc, None


class _JetDense(torch.autograd.Function):
    """Forward: the fused kernel (plain version on CPU).  Backward: a
    recompute through the plain version."""

    @staticmethod
    def forward(ctx, coeffs, w, b, activation):
        ctx.activation = activation
        ctx.save_for_backward(coeffs, w, b)
        return _jet_dense_impl(coeffs, w, b, activation)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = ref.jet_dense_ref(*leaves, ctx.activation)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def act_jet(coeffs: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """Activation jet (n+1, *batch, W) -> same shape."""
    _check_activation(activation, allow_none=False)
    _check_stack(coeffs)
    flat, batch = _fold_batch(coeffs)
    out = _ActJet.apply(flat, activation)
    return out.reshape(tuple(out.shape[:1]) + batch + tuple(out.shape[-1:]))


def jet_dense(coeffs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              activation: str | None = "tanh") -> torch.Tensor:
    """Fused dense layer + activation jet: (n+1, *batch, Din) -> (n+1,
    *batch, Dout).  Extra leading batch axes fold into the kernel's batch
    dimension and unfold on the way out."""
    _check_activation(activation, allow_none=True)
    _check_stack(coeffs)
    flat, batch = _fold_batch(coeffs)
    out = _JetDense.apply(flat, w, b, activation)
    return out.reshape(tuple(out.shape[:1]) + batch + tuple(out.shape[-1:]))


# ---------------------------------------------------------------------------
# the transformer trunk: fused rms_norm and the flash-jet attention block
# ---------------------------------------------------------------------------

def _rms_norm_impl(coeffs, gamma, eps):
    if _on_cpu(coeffs):
        return ref.jet_rms_norm_ref(coeffs, gamma, eps)
    return _k34.jet_rms_norm_cuda(coeffs.contiguous(), gamma.contiguous(), eps)


class _RMSNorm(torch.autograd.Function):
    """Forward: the fused kernel (plain version on CPU).  Backward: a
    recompute through the plain version."""

    @staticmethod
    def forward(ctx, coeffs, gamma, eps):
        ctx.eps = eps
        ctx.save_for_backward(coeffs, gamma)
        return _rms_norm_impl(coeffs, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = ref.jet_rms_norm_ref(*leaves, ctx.eps)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def jet_rms_norm(coeffs: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Fused rms_norm jet: (n+1, *batch, W) -> same shape, normalized over
    the trailing feature axis and scaled by the (W,) gain.  Leading batch
    axes (the token axis included) fold into the kernel's batch dimension."""
    _check_stack(coeffs)
    flat, batch = _fold_batch(coeffs)
    out = _RMSNorm.apply(flat, gamma, eps)
    return out.reshape(tuple(out.shape[:1]) + batch + tuple(out.shape[-1:]))


def _flash_attention_impl(q, k, v, wo, scale, mask):
    kind, window = mask
    if _on_cpu(q):
        from repro_torch.core.modules import attention_mask
        return ref.jet_flash_attention_ref(
            q, k, v, wo, scale, mask=attention_mask(mask, q.shape[-2]))
    # SelfAttention hands over (B, T, H, Dh) projections viewed as
    # (B, H, T, Dh); the kernel reads contiguous stacks
    return _k34.jet_flash_attention_cuda(q.contiguous(), k.contiguous(),
                                         v.contiguous(), wo.contiguous(),
                                         scale, kind, window)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel (plain version on CPU).  Backward: a
    recompute through the plain version with the dense keep-matrix, as the
    reference's ``_flash_attention_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, wo, scale, mask):
        ctx.scale, ctx.mask = scale, mask
        ctx.save_for_backward(q, k, v, wo)
        return _flash_attention_impl(q, k, v, wo, scale, mask)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.modules import attention_mask
        inputs = ctx.saved_tensors
        dense = attention_mask(ctx.mask, inputs[0].shape[-2], inputs[0].device)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = ref.jet_flash_attention_ref(*leaves, ctx.scale, mask=dense)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def jet_flash_attention(q_coeffs: torch.Tensor, k_coeffs: torch.Tensor,
                        v_coeffs: torch.Tensor, wo: torch.Tensor,
                        scale: float, mask=None) -> torch.Tensor:
    """Flash-jet attention block: Q/K/V stacks (n+1, *batch, H, T, Dh) plus
    the output projection ``wo`` -- (H*Dh, Dm) as stored by
    ``SelfAttention`` (head-major rows), or already (H, Dh, Dm) -- to the
    block output jet (n+1, *batch, T, Dm) in one launch.  ``mask`` is
    anything ``repro_torch.core.modules.normalize_attention_mask`` accepts.
    Extra leading batch axes fold into the kernel's batch dimension and
    unfold on the way out."""
    from repro_torch.core.modules import normalize_attention_mask
    mask = normalize_attention_mask(mask)
    _check_stack(q_coeffs)
    h, d = q_coeffs.shape[-3], q_coeffs.shape[-1]
    if wo.ndim == 2:
        wo = wo.reshape(h, d, wo.shape[-1])
    qf, batch = _fold_batch(q_coeffs, keep=3)
    kf, _ = _fold_batch(k_coeffs, keep=3)
    vf, _ = _fold_batch(v_coeffs, keep=3)
    out = _FlashAttention.apply(qf, kf, vf, wo, scale, mask)
    return out.reshape(tuple(out.shape[:1]) + batch + tuple(out.shape[-2:]))


# ---------------------------------------------------------------------------
# the materializing attention-score jet: Cauchy-product QK^T + scale +
# softmax recurrences in one launch; no module dispatches it (SelfAttention
# runs the flash kernel), it is the public op and the T^2 side of the
# flash-vs-scores memory comparison
# ---------------------------------------------------------------------------

def _attention_scores_impl(q, k, scale):
    if _on_cpu(q):
        return ref.jet_attention_scores_ref(q, k, scale)
    return _k34.jet_attention_scores_cuda(q.contiguous(), k.contiguous(), scale)


class _AttentionScores(torch.autograd.Function):
    """Forward: the score kernel (plain version on CPU).  Backward: a
    recompute through the plain version, as the reference's
    ``_attention_scores_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k)
        return _attention_scores_impl(q, k, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = ref.jet_attention_scores_ref(*leaves, ctx.scale)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def jet_attention_scores(q_coeffs: torch.Tensor, k_coeffs: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Fused attention-score jet: Q/K stacks (n+1, *batch, T, D) -> the
    softmaxed probability jet (n+1, *batch, Tq, Tk).  Extra leading batch
    axes (collocation batch, head axis) fold into the kernel's batch
    dimension and unfold on the way out."""
    _check_stack(q_coeffs)
    qf, batch = _fold_batch(q_coeffs, keep=2)
    kf, _ = _fold_batch(k_coeffs, keep=2)
    out = _AttentionScores.apply(qf, kf, scale)
    return out.reshape(tuple(out.shape[:1]) + batch + tuple(out.shape[-2:]))
