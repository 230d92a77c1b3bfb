"""PyTorch/CUDA port of the n-TangentProp reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``parallel/``, ``serving/``, ``runtime/``) so each
ported file has one counterpart there, and imports neither ``jax`` nor
``repro``.

Impl names: ``"torch"`` is the eager jet algebra (engine spec ``"ntp"``),
``"cuda"`` routes every dense layer through the hand-written CUDA kernels in
``kernels/csrc/`` (spec ``"ntp/cuda"``).  Entry points that allocate
(``init_mlp``, ``DenseMLP.init``, ``DerivativeServer``, the bridge) run on
the CUDA device unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
