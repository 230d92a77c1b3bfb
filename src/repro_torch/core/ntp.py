"""n-TangentProp: the paper's algorithm (Alg. 1) for dense feed-forward nets.

Compute ``f(x), f'(x), ..., f^(n)(x)`` w.r.t. the *network inputs* in a single
forward pass.  Linear layers act coefficient-wise on the jet; activations go
through the Faa di Bruno contraction.  Cost is ``O(n p(n) M)`` time and
``O(n M)`` memory -- quasilinear in the model size M, versus ``O(M^n)`` for
nested autodiff.

Two execution paths:
* ``impl='torch'`` -- eager jet algebra (core/jet.py);
* ``impl='cuda'``  -- every hidden layer runs the fused ``jet_dense`` kernel
                      (kernels/ops.py), GEMM and activation jet in one launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.device import resolve_device

from . import jet as J


class MLPParams(NamedTuple):
    """Stacked weights for a uniform-width MLP (paper's architecture)."""

    w_in: torch.Tensor      # (d_in, width)
    b_in: torch.Tensor      # (width,)
    w_hidden: torch.Tensor  # (depth-1, width, width)
    b_hidden: torch.Tensor  # (depth-1, width)
    w_out: torch.Tensor     # (width, d_out)
    b_out: torch.Tensor     # (d_out,)


def xavier_uniform(generator: torch.Generator, fan_in: int, fan_out: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Xavier-uniform weight init (the paper's PyTorch default).  Draws come
    from ``generator`` on the CPU and then move to ``device``, so one seed
    gives the same weights on every device."""
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_in, fan_out), generator=generator, dtype=dtype)
    return ((2.0 * u - 1.0) * lim).to(resolve_device(device))


def init_mlp(generator: torch.Generator, d_in: int, width: int, depth: int,
             d_out: int, dtype=torch.float32, device=None) -> MLPParams:
    """Xavier weights, zero biases; layers are drawn in order input, hidden
    1..depth-1, output.  ``device=None`` is the CUDA device (raises without
    one)."""
    device = resolve_device(device)

    def xavier(fan_in, fan_out):
        return xavier_uniform(generator, fan_in, fan_out, dtype, device)

    w_in = xavier(d_in, width)
    wh = torch.stack([xavier(width, width) for _ in range(depth - 1)]) \
        if depth > 1 else torch.zeros((0, width, width), dtype=dtype,
                                      device=device)
    w_out = xavier(width, d_out)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return MLPParams(w_in=w_in, b_in=zeros(width), w_hidden=wh,
                     b_hidden=zeros(max(depth - 1, 0), width),
                     w_out=w_out, b_out=zeros(d_out))


def mlp_apply(params: MLPParams, x: torch.Tensor,
              activation: str = "tanh") -> torch.Tensor:
    """Plain forward pass (no derivatives)."""
    from .activations import PRIMALS
    act = PRIMALS[activation]
    h = act(x @ params.w_in + params.b_in)
    for i in range(params.w_hidden.shape[0]):
        h = act(h @ params.w_hidden[i] + params.b_hidden[i])
    return h @ params.w_out + params.b_out


# ---------------------------------------------------------------------------
# the n-TangentProp forward pass
# ---------------------------------------------------------------------------

def ntp_jet(params: MLPParams, jet: J.Jet, activation: str = "tanh",
            impl: str = "torch") -> J.Jet:
    """Push an input jet through the dense stack (the body of Algorithm 1).

    Under ``impl="cuda"`` the input and hidden layers run the fused kernel
    (:func:`repro_torch.core.modules.dense_jet`, which composes activations
    without a kernel epilogue through the jet algebra) and the readout runs
    :func:`repro_torch.core.jet.linear`, as the reference's Pallas branch
    does."""
    if impl == "cuda":
        from .modules import dense_jet
        jet = dense_jet(jet, params.w_in, params.b_in, activation, impl)
        for i in range(params.w_hidden.shape[0]):
            jet = dense_jet(jet, params.w_hidden[i], params.b_hidden[i],
                            activation, impl)
        return J.linear(jet, params.w_out, params.b_out)

    jet = J.compose(J.linear(jet, params.w_in, params.b_in), activation)
    for i in range(params.w_hidden.shape[0]):
        jet = J.compose(J.linear(jet, params.w_hidden[i], params.b_hidden[i]),
                        activation)
    return J.linear(jet, params.w_out, params.b_out)


def ntp_forward(params: MLPParams, x: torch.Tensor, order: int,
                tangent: torch.Tensor | None = None, activation: str = "tanh",
                impl: str = "torch") -> J.Jet:
    """Jet of the network output along the input curve ``x + t v``.

    ``x``: (batch, d_in).  ``tangent`` defaults to ones (the paper's 1-D PINN
    seeding).  Returns a Jet of (batch, d_out).
    """
    if order == 0:
        y = mlp_apply(params, x, activation)
        return J.Jet(y[None])
    return ntp_jet(params, J.seed(x, tangent, order), activation, impl)


def ntp_derivatives(params: MLPParams, x: torch.Tensor, order: int,
                    tangent: torch.Tensor | None = None, activation: str = "tanh",
                    impl: str = "torch") -> torch.Tensor:
    """Raw derivatives (order+1, batch, d_out): d^k/dt^k f(x + t v) at t=0."""
    return J.derivatives(ntp_forward(params, x, order, tangent, activation, impl))


# ---------------------------------------------------------------------------
# multi-directional jets: the direction folding and polarization algebra
# live in core/engines.py; these wrappers keep the MLPParams surface.
# ---------------------------------------------------------------------------

def _dense_view(params: MLPParams, activation: str, impl: str):
    from .engines import NTPEngine
    from .network import DenseMLP
    return DenseMLP.from_params(params, activation), NTPEngine(impl)


def ntp_grid(params: MLPParams, x: torch.Tensor, order: int,
             activation: str = "tanh", impl: str = "torch") -> torch.Tensor:
    """Pure n-th derivatives along each coordinate axis: (d_in, order+1, batch, d_out)."""
    net, engine = _dense_view(params, activation, impl)
    return engine.grid(net, params, x, order)


def cross(params: MLPParams, x: torch.Tensor, axes: Sequence[int],
          activation: str = "tanh", impl: str = "torch") -> torch.Tensor:
    """Mixed partial ``d^m f / dx_{axes[0]} ... dx_{axes[m-1]}`` at each point,
    shape (batch, d_out), by polarization of 2^m directional jets (see
    :meth:`repro_torch.core.engines.DerivativeEngine.cross`)."""
    net, engine = _dense_view(params, activation, impl)
    return engine.cross(net, params, x, axes)
