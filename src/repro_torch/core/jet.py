"""Taylor-jet algebra: the n-TangentProp derivative stack and its arithmetic.

A ``Jet`` holds scaled Taylor coefficients ``c_k = (1/k!) d^k x(t)/dt^k`` of a
quantity along a 1-parameter input curve ``t -> f(x0 + t v)``, stacked on a
leading axis: ``coeffs[k]`` has the shape of the underlying tensor.  In that
normalization every rule below is a power-series identity with small integer
constants:

* linear maps apply coefficient-wise (bias touches only ``c_0``);
* products are Cauchy convolutions ``(AB)_k = sum_{i+j=k} A_i B_j``;
* smooth scalar functions compose via the Taylor-normalized Faa di Bruno
  contraction (core/partitions.py) with closed-form outer coefficients
  (core/activations.py).

It is the reference algebra (``repro.core.jet``) op for op: the dense
path, the activations, the transformer trunk (softmax, rms_norm and the
power-series recurrences under them), ``log`` and ``layer_norm``.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from .activations import GELU_TANH_C, GELU_TANH_CUBIC, TAYLOR_STACKS
from .partitions import faa_di_bruno_table


class Jet:
    """Stack of scaled Taylor coefficients c_0..c_n on a leading axis."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: torch.Tensor):
        self.coeffs = coeffs

    @property
    def order(self) -> int:
        return self.coeffs.shape[0] - 1

    @property
    def primal(self) -> torch.Tensor:
        return self.coeffs[0]

    @property
    def shape(self):
        return tuple(self.coeffs.shape[1:])

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    def __repr__(self):
        return f"Jet(order={self.order}, shape={self.shape}, dtype={self.dtype})"

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(other, self)

    def __mul__(self, other):
        return mul(self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return Jet(-self.coeffs)


JetLike = Union[Jet, torch.Tensor, float, int]


# ---------------------------------------------------------------------------
# construction / extraction
# ---------------------------------------------------------------------------

def seed(x: torch.Tensor, v: torch.Tensor | None, order: int) -> Jet:
    """Jet of the curve t -> x + t v  (c_0 = x, c_1 = v, higher = 0)."""
    if v is None:
        v = torch.ones_like(x)
    zeros = [torch.zeros_like(x) for _ in range(order - 1)]
    return Jet(torch.stack([x, v.to(x.dtype)] + zeros))


def const(x: JetLike, order: int, like: Jet | None = None) -> Jet:
    """Constant-in-t jet (only c_0 populated).  A Python number is filled
    in on ``like``'s device: a host-made tensor would be a blocking copy on
    every call (``rms_norm``'s eps, the softmax mask constant)."""
    if isinstance(x, Jet):
        return x
    if like is not None and isinstance(x, (int, float)):
        x = torch.full((), x, dtype=like.dtype, device=like.device)
    elif like is not None:
        x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    else:
        x = torch.as_tensor(x)
    return Jet(torch.cat([x[None], x.new_zeros((order,) + tuple(x.shape))]))


def _factorials(n: int, like: torch.Tensor) -> torch.Tensor:
    """[0!, 1!, ..., n!] on ``like``'s device, built there (a host-made
    tensor would be a blocking copy on every call); exact in float64 while
    n! < 2^53."""
    k = torch.arange(n + 1, dtype=like.dtype, device=like.device)
    return k.clamp_(min=1).cumprod(0)


def derivatives(j: Jet) -> torch.Tensor:
    """Raw derivatives d^k f/dt^k = k! * c_k, stacked (order+1, *shape)."""
    facts = _factorials(j.order, j.coeffs)
    return j.coeffs * facts.reshape((-1,) + (1,) * len(j.shape))


def from_derivatives(d: torch.Tensor) -> Jet:
    """Inverse of :func:`derivatives`."""
    inv = _factorials(d.shape[0] - 1, d).reciprocal()
    return Jet(d * inv.reshape((-1,) + (1,) * (d.ndim - 1)))


def _align(a: Jet, b: Jet) -> tuple[Jet, Jet]:
    """Insert singleton dims after the coefficient axis so the *underlying*
    shapes broadcast by trailing-dim rules (coeff axis stays leading)."""
    na, nb = len(a.shape), len(b.shape)
    if na < nb:
        a = Jet(a.coeffs.reshape(a.coeffs.shape[:1] + (1,) * (nb - na) + a.shape))
    elif nb < na:
        b = Jet(b.coeffs.reshape(b.coeffs.shape[:1] + (1,) * (na - nb) + b.shape))
    return a, b


def _promote(a: JetLike, b: JetLike) -> tuple[Jet, Jet]:
    if isinstance(a, Jet) and isinstance(b, Jet):
        if a.order != b.order:
            raise ValueError(f"jet order mismatch: {a.order} vs {b.order}")
        return _align(a, b)
    if isinstance(a, Jet):
        return _align(a, const(b, a.order, like=a))
    if isinstance(b, Jet):
        return _align(const(a, b.order, like=b), b)
    raise TypeError("at least one operand must be a Jet")


# ---------------------------------------------------------------------------
# linear operations (coefficient-wise)
# ---------------------------------------------------------------------------

def jmap(fn: Callable[..., torch.Tensor], *jets: Jet) -> Jet:
    """Apply a *linear* tensor function to each coefficient (reshape,
    reduce-sum, transpose, slice, concat of jets, ...)."""
    n = jets[0].order
    rows = [fn(*(j.coeffs[k] for j in jets)) for k in range(n + 1)]
    return Jet(torch.stack(rows))


def add(a: JetLike, b: JetLike) -> Jet:
    a, b = _promote(a, b)
    return Jet(a.coeffs + b.coeffs)


def sub(a: JetLike, b: JetLike) -> Jet:
    a, b = _promote(a, b)
    return Jet(a.coeffs - b.coeffs)


def scale(a: Jet, s) -> Jet:
    """Multiply by a t-constant scalar/tensor (broadcasts like tensors)."""
    return Jet(a.coeffs * s)


def linear(a: Jet, w: torch.Tensor, b: torch.Tensor | None = None) -> Jet:
    """Dense layer on a jet: W acts on every coefficient, bias only on c_0.

    The coefficient axis (and any leading batch axes) folds into the
    ellipsis, so the whole stack contracts in ONE einsum instead of
    per-coefficient calls."""
    out = torch.einsum("...i,ij->...j", a.coeffs, w)
    if b is not None:
        out = torch.cat([out[:1] + b, out[1:]])
    return Jet(out)


def _stack_axes(axis):
    """Axes of the underlying tensor -> axes of the coefficient stack."""
    if isinstance(axis, int):
        return axis if axis < 0 else axis + 1
    return tuple(_stack_axes(a) for a in axis)


def reduce_sum(a: Jet, axis, keepdims: bool = False) -> Jet:
    return Jet(a.coeffs.sum(dim=_stack_axes(axis), keepdim=keepdims))


def reduce_mean(a: Jet, axis, keepdims: bool = False) -> Jet:
    return Jet(a.coeffs.mean(dim=_stack_axes(axis), keepdim=keepdims))


def where(mask: torch.Tensor, a: JetLike, b: JetLike) -> Jet:
    """Select with a t-constant predicate (exact a.e.; mask must not depend on t)."""
    a, b = _promote(a, b)
    return jmap(lambda x, y: torch.where(mask, x, y), a, b)


# ---------------------------------------------------------------------------
# bilinear operations (Cauchy convolution over the coefficient axis)
# ---------------------------------------------------------------------------

def _cauchy(a: Jet, b: Jet,
            combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> Jet:
    n = a.order
    rows = []
    for k in range(n + 1):
        acc = combine(a.coeffs[0], b.coeffs[k])
        for i in range(1, k + 1):
            acc = acc + combine(a.coeffs[i], b.coeffs[k - i])
        rows.append(acc)
    return Jet(torch.stack(rows))


def mul(a: JetLike, b: JetLike) -> Jet:
    a, b = _promote(a, b)
    return _cauchy(a, b, torch.mul)


def einsum(eq: str, a: JetLike, b: JetLike) -> Jet:
    """Jet-valued contraction: out_k = sum_{i+j=k} einsum(eq, a_i, b_j).

    If one operand is t-constant the convolution degenerates to a per-
    coefficient einsum.  No broadcast alignment: the subscripts fix the
    ranks."""
    if isinstance(a, Jet) and not isinstance(b, Jet):
        return jmap(lambda c: torch.einsum(eq, c, b), a)
    if isinstance(b, Jet) and not isinstance(a, Jet):
        return jmap(lambda c: torch.einsum(eq, a, c), b)
    if a.order != b.order:
        raise ValueError(f"jet order mismatch: {a.order} vs {b.order}")
    return _cauchy(a, b, lambda x, y: torch.einsum(eq, x, y))


# ---------------------------------------------------------------------------
# power-series recurrences
# ---------------------------------------------------------------------------

def exp(a: Jet) -> Jet:
    """e_0 = exp(a_0);  e_k = (1/k) sum_{j=1..k} j a_j e_{k-j}."""
    n = a.order
    rows = [torch.exp(a.coeffs[0])]
    for k in range(1, n + 1):
        acc = a.coeffs[k] * rows[0] * k  # j = k term
        for j in range(1, k):
            acc = acc + j * a.coeffs[j] * rows[k - j]
        rows.append(acc / k)
    return Jet(torch.stack(rows))


def log(a: Jet) -> Jet:
    """l_0 = log a_0;  l_k = (a_k - (1/k) sum_{j=1..k-1} j l_j a_{k-j}) / a_0."""
    n = a.order
    inv0 = 1.0 / a.coeffs[0]
    rows = [torch.log(a.coeffs[0])]
    for k in range(1, n + 1):
        acc = a.coeffs[k]
        for j in range(1, k):
            acc = acc - (j / k) * rows[j] * a.coeffs[k - j]
        rows.append(acc * inv0)
    return Jet(torch.stack(rows))


def div(a: JetLike, b: JetLike) -> Jet:
    """c_k = (a_k - sum_{j=1..k} b_j c_{k-j}) / b_0."""
    a, b = _promote(a, b)
    inv0 = 1.0 / b.coeffs[0]
    rows = [a.coeffs[0] * inv0]
    for k in range(1, a.order + 1):
        acc = a.coeffs[k]
        for j in range(1, k + 1):
            acc = acc - b.coeffs[j] * rows[k - j]
        rows.append(acc * inv0)
    return Jet(torch.stack(rows))


def powr(a: Jet, r: float) -> Jet:
    """a^r (real r) via the J.C.P. Miller recurrence:
    c_k = (1/(k a_0)) sum_{j=1..k} ((r+1) j - k) a_j c_{k-j}."""
    n = a.order
    inv0 = 1.0 / a.coeffs[0]
    rows = [torch.pow(a.coeffs[0], r)]
    for k in range(1, n + 1):
        acc = ((r + 1) * 1 - k) * a.coeffs[1] * rows[k - 1]
        for j in range(2, k + 1):
            acc = acc + ((r + 1) * j - k) * a.coeffs[j] * rows[k - j]
        rows.append(acc * inv0 / k)
    return Jet(torch.stack(rows))


def sqrt(a: Jet) -> Jet:
    return powr(a, 0.5)


def rsqrt(a: Jet) -> Jet:
    return powr(a, -0.5)


# ---------------------------------------------------------------------------
# smooth scalar composition (Faa di Bruno)
# ---------------------------------------------------------------------------

def compose(a: Jet, name: str) -> Jet:
    """sigma(a) for a registered smooth activation, via the Taylor-normalized
    Faa di Bruno contraction with closed-form outer coefficients."""
    n = a.order
    fstack = TAYLOR_STACKS[name](a.coeffs[0], n)  # (n+1, *shape)
    rows = [fstack[0]]
    for k in range(1, n + 1):
        acc = None
        for term in faa_di_bruno_table(k):
            prod = fstack[term.order] * float(term.coef)
            for j, e in term.powers:
                cj = a.coeffs[j]
                for _ in range(e):
                    prod = prod * cj
            acc = prod if acc is None else acc + prod
        rows.append(acc)
    return Jet(torch.stack(rows))


def tanh(a: Jet) -> Jet:
    return compose(a, "tanh")


def sigmoid(a: Jet) -> Jet:
    return compose(a, "sigmoid")


def sin(a: Jet) -> Jet:
    return compose(a, "sin")


def softplus(a: Jet) -> Jet:
    return compose(a, "softplus")


def silu(a: Jet) -> Jet:
    return mul(a, sigmoid(a))


def gelu(a: Jet) -> Jet:
    """tanh-approximation GELU as a pure jet composition (poly + tanh + mul);
    constants shared with PRIMALS['gelu'] via core.activations."""
    a3 = mul(mul(a, a), a)
    inner = scale(add(a, scale(a3, GELU_TANH_CUBIC)), GELU_TANH_C)
    return scale(mul(a, add(tanh(inner), 1.0)), 0.5)


def relu(a: Jet) -> Jet:
    """Piecewise-linear: exact wherever a_0 != 0 (jets vanish on the off side)."""
    return where(a.coeffs[0] > 0, a, scale(a, 0.0))


def identity(a: Jet) -> Jet:
    return a


_COMPOSITE_ACTS: dict[str, Callable[[Jet], Jet]] = {
    "silu": silu, "gelu": gelu, "relu": relu, "identity": identity,
}


def activation(a: Jet, name: str) -> Jet:
    """Named activation on a jet: table-backed names go through the Faa di
    Bruno contraction (:func:`compose`); composite ones (silu, gelu, relu,
    identity) through their jet-algebra definitions.  The single dispatch
    point for :class:`repro_torch.core.modules.Dense`/``Activation`` leaves."""
    if name in TAYLOR_STACKS:
        return compose(a, name)
    if name in _COMPOSITE_ACTS:
        return _COMPOSITE_ACTS[name](a)
    raise KeyError(f"unknown activation {name!r}; known: "
                   f"{sorted(set(TAYLOR_STACKS) | set(_COMPOSITE_ACTS))}")


# ---------------------------------------------------------------------------
# softmax & norms (built from the primitives; used by attention jets)
# ---------------------------------------------------------------------------

# Finite stand-in for -inf at masked softmax positions: exp underflows to
# exactly 0 (killing the whole e-jet there by the exp recurrence), while
# arithmetic on it stays NaN-free -- a true -inf would produce inf - inf
# under the shift and 0 * inf in the recurrences.  The flash kernel
# (kernels/csrc/jet_flash_attention.cu) uses the same constant.
MASK_NEG = -1e30


def softmax(a: Jet, axis: int = -1, mask: torch.Tensor | None = None) -> Jet:
    """Softmax jet over ``axis``; ``mask`` is an optional t-constant boolean
    keep-matrix (True = attend, broadcastable against the coefficients).
    Masked positions are replaced by the constant jet ``MASK_NEG`` *before*
    the exp recurrence, so their probability jets vanish identically at
    every order.  A row that keeps no position becomes the uniform
    distribution with zero higher-order coefficients.  The shift is
    detached: it is t-constant and cancels in the division."""
    if mask is not None:
        a = where(mask, a, MASK_NEG)
    shift = a.coeffs[0].amax(dim=axis, keepdim=True).detach()
    e = exp(sub(a, const(shift, a.order, like=a)))
    s = reduce_sum(e, axis=axis, keepdims=True)
    return div(e, s)


def rms_norm(x: Jet, gamma: torch.Tensor, eps: float = 1e-6,
             axis: int = -1, offset: float = 0.0) -> Jet:
    ms = reduce_mean(mul(x, x), axis=axis, keepdims=True)
    inv = rsqrt(add(ms, eps))
    return scale(mul(x, inv), (offset + gamma))


def layer_norm(x: Jet, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
               axis: int = -1) -> Jet:
    mu = reduce_mean(x, axis=axis, keepdims=True)
    xc = sub(x, mu)
    var = reduce_mean(mul(xc, xc), axis=axis, keepdims=True)
    y = mul(xc, rsqrt(add(var, eps)))
    y = scale(y, gamma)
    return add(y, const(beta, x.order, like=x))
