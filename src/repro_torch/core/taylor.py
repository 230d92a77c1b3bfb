"""Taylor mode at the level of torch operations: the port's counterpart of
``jax.experimental.jet``, an oracle independent of the layer-level jet
algebra (``core/jet.py``) that n-TangentProp runs.

A :class:`Taylor` is a tensor that carries, beside its value, the truncated
Taylor series of the curve it lies on: ``coeffs`` (n+1, *shape) with
``coeffs[0]`` the value and ``coeffs[k]`` the k-th normalized coefficient
(the k-th derivative along the curve over k!).  Every torch operation on a
:class:`Taylor` goes through ``__torch_function__`` and one rule per
operation, the standard recurrences of Taylor arithmetic (Griewank and
Walther, *Evaluating Derivatives*, ch. 13), which are the ones
``jax.experimental.jet`` applies primitive by primitive:

* Cauchy products for ``mul``, ``matmul`` and ``einsum``, and the division
  recurrence for ``div``;
* the ODE recurrences of ``exp``, ``log``, ``tanh``, ``sigmoid``,
  ``sin``/``cos``, ``pow`` (hence ``rsqrt`` and ``sqrt``) and ``logaddexp``
  (softplus); ``softmax`` is exp, sum and division;
* linearity for ``add``/``sub``/``neg``, ``sum``/``mean``, ``reshape``,
  ``cat``, indexing and ``where`` (constants enter coefficient 0 only).

That covers every operation the port's ``apply`` methods call
(``core/modules.py``, ``core/ntp.py``, the ``PRIMALS`` activations).  An
operation without a rule raises and names it: nothing falls back to
autograd.  :func:`taylor_derivatives` seeds the input curve ``x + t v`` as
``jax.experimental.jet`` does in its raw-derivative convention, the series
``(v, 0, ..., 0)``, and returns raw derivatives.  The cost is that of the
recurrences, O(n^2) per operation, with no cap on the order.

This module imports nothing of ``core/jet.py``: its independence is the
point of the oracle.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

Coeffs = List[torch.Tensor]

# attribute reads that do not depend on the series (``x.shape`` reaches
# __torch_function__ as a getset descriptor's __get__)
_METADATA_ATTRS = {"shape", "dtype", "device", "ndim"}
_METADATA_CALLS = {"size", "dim"}


class Taylor(torch.Tensor):
    """A tensor with its truncated Taylor series; see the module docstring.
    The tensor's own data is ``coeffs[0]``, detached: every rule computes on
    ``coeffs``, so autograd flows through the series."""

    coeffs: torch.Tensor

    @staticmethod
    def __new__(cls, coeffs: torch.Tensor):
        out = torch.Tensor._make_subclass(cls, coeffs[0].detach())
        out.coeffs = coeffs
        return out

    @property
    def order(self) -> int:
        return self.coeffs.shape[0] - 1

    def __repr__(self) -> str:
        return f"Taylor(order={self.order}, coeffs={self.coeffs!r})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (name == "__get__" and getattr(getattr(func, "__self__", None), "__name__", "")
                in _METADATA_ATTRS) or name in _METADATA_CALLS:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        rule = _RULES.get(name)
        if rule is None:
            raise NotImplementedError(
                f"Taylor mode has no rule for torch op {name or func!r}")
        return rule(*args, **kwargs)


# ---------------------------------------------------------------------------
# series helpers: a Taylor's coefficients as a list, a constant's as
# (value, 0, ..., 0)
# ---------------------------------------------------------------------------

def _order(*args) -> int:
    for a in args:
        if isinstance(a, Taylor):
            return a.order
        if isinstance(a, (list, tuple)):
            n = _order(*a)
            if n >= 0:
                return n
    return -1


def _series(a, n: int) -> Coeffs:
    """Coefficients 0..n of ``a``: its own if a Taylor, else the constant's."""
    if isinstance(a, Taylor):
        return list(a.coeffs.unbind(0))
    zero = torch.zeros_like(a) if isinstance(a, torch.Tensor) else 0.0
    return [a] + [zero] * n


def _wrap(cs: Coeffs) -> Taylor:
    return Taylor(torch.stack(cs))


def _cauchy(f: Callable, a: Coeffs, b: Coeffs, k: int):
    """Coefficient k of the product ``f`` of two series: sum_j f(a_j, b_{k-j})."""
    out = f(a[0], b[k])
    for j in range(1, k + 1):
        out = out + f(a[j], b[k - j])
    return out


def _bilinear(f: Callable, a, b) -> Taylor:
    """``f`` bilinear (a product or a contraction): a Cauchy product of two
    series, coefficient by coefficient when one side is constant."""
    n = _order(a, b)
    if not isinstance(b, Taylor):
        return _wrap([f(ak, b) for ak in _series(a, n)])
    if not isinstance(a, Taylor):
        return _wrap([f(a, bk) for bk in _series(b, n)])
    sa, sb = _series(a, n), _series(b, n)
    return _wrap([_cauchy(f, sa, sb, k) for k in range(n + 1)])


def _linear(method: str) -> Callable:
    """A rule for the tensor method ``method``, linear in the tensor, its
    other arguments constant: applied coefficient by coefficient."""
    def rule(a, *rest, **kwargs):
        if _order(rest, tuple(kwargs.values())) >= 0:
            raise NotImplementedError(f"Taylor mode: {method} is linear in its "
                                      "first argument only")
        return _wrap([getattr(ak, method)(*rest, **kwargs) for ak in a.coeffs.unbind(0)])
    return rule


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _add(a, b, *, alpha=1):
    n = _order(a, b)
    sa, sb = _series(a, n), _series(b, n)
    return _wrap([x + alpha * y for x, y in zip(sa, sb)])


def _sub(a, b, *, alpha=1):
    return _add(a, _neg(b) if isinstance(b, Taylor) else -b, alpha=alpha)


def _rsub(a, b, *, alpha=1):            # b - alpha * a
    return _add(b, _neg(a), alpha=alpha)


def _neg(a):
    return Taylor(-a.coeffs) if isinstance(a, Taylor) else -a


def _mul(a, b):
    return _bilinear(torch.mul, a, b)


def _div(a, b, *, rounding_mode=None):
    """c = a / b: c_k = (a_k - sum_{j=1}^k b_j c_{k-j}) / b_0."""
    if rounding_mode is not None:
        raise NotImplementedError(f"Taylor mode: div with rounding_mode={rounding_mode!r}")
    n = _order(a, b)
    if not isinstance(b, Taylor):
        return _wrap([ak / b for ak in _series(a, n)])
    sa, sb = _series(a, n), _series(b, n)
    c = [sa[0] / sb[0]]
    for k in range(1, n + 1):
        acc = sa[k]
        for j in range(1, k + 1):
            acc = acc - sb[j] * c[k - j]
        c.append(acc / sb[0])
    return _wrap(c)


def _rdiv(a, b):                        # b / a
    return _div(b, a)


def _powr(x: Coeffs, p: float, y0: torch.Tensor) -> Coeffs:
    """y = x^p from y_0: k x_0 y_k = sum_{j=1}^k (p j - (k - j)) x_j y_{k-j}."""
    y = [y0]
    for k in range(1, len(x)):
        acc = (p * k) * x[k] * y[0]
        for j in range(1, k):
            acc = acc + (p * j - (k - j)) * x[j] * y[k - j]
        y.append(acc / (k * x[0]))
    return y


def _pow(a, p):
    if isinstance(p, torch.Tensor) or not isinstance(a, Taylor):
        raise NotImplementedError("Taylor mode: pow takes a Taylor base and a number "
                                  "exponent")
    if float(p) == int(p) and p >= 0:
        # a non-negative integer power by repeated Cauchy products: exact at
        # a_0 = 0 too, where the recurrence would divide by zero
        out = _wrap(_series(torch.ones_like(a.coeffs[0]), a.order))
        for _ in range(int(p)):
            out = _mul(out, a)
        return out
    x = _series(a, a.order)
    return _wrap(_powr(x, float(p), x[0] ** p))


def _rsqrt(a):
    x = _series(a, a.order)
    return _wrap(_powr(x, -0.5, torch.rsqrt(x[0])))


def _sqrt(a):
    x = _series(a, a.order)
    return _wrap(_powr(x, 0.5, torch.sqrt(x[0])))


def _matmul(a, b):
    return _bilinear(torch.matmul, a, b)


def _rmatmul(a, b):                     # b @ a
    return _bilinear(torch.matmul, b, a)


def _einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    live = [i for i, op in enumerate(operands) if isinstance(op, Taylor)]
    if len(live) == 1:
        i = live[0]
        return _wrap([torch.einsum(equation, *operands[:i], ck, *operands[i + 1:])
                      for ck in operands[i].coeffs.unbind(0)])
    if len(operands) != 2:
        raise NotImplementedError("Taylor mode: einsum of more than two series")
    return _bilinear(lambda x, y: torch.einsum(equation, x, y), *operands)


# ---------------------------------------------------------------------------
# elementwise functions: the ODE recurrences
# ---------------------------------------------------------------------------

def _chain(x: Coeffs, dy: Coeffs, k: int):
    """Coefficient k >= 1 of y where y' = dy * x': (1/k) sum_{j=1}^k j x_j dy_{k-j}."""
    acc = x[1] * dy[k - 1]
    for j in range(2, k + 1):
        acc = acc + j * x[j] * dy[k - j]
    return acc / k


def _exp(a):
    x = _series(a, a.order)
    y = [torch.exp(x[0])]
    for k in range(1, len(x)):
        y.append(_chain(x, y, k))
    return _wrap(y)


def _log(a):
    """k x_0 y_k = k x_k - sum_{j=1}^{k-1} (k - j) x_j y_{k-j}."""
    x = _series(a, a.order)
    y = [torch.log(x[0])]
    for k in range(1, len(x)):
        acc = k * x[k]
        for j in range(1, k):
            acc = acc - (k - j) * x[j] * y[k - j]
        y.append(acc / (k * x[0]))
    return _wrap(y)


def _sin_cos(x: Coeffs):
    s, c = [torch.sin(x[0])], [torch.cos(x[0])]
    for k in range(1, len(x)):
        s.append(_chain(x, c, k))
        c.append(-_chain(x, s, k))
    return s, c


def _sin(a):
    return _wrap(_sin_cos(_series(a, a.order))[0])


def _cos(a):
    return _wrap(_sin_cos(_series(a, a.order))[1])


def _square_law(x: Coeffs, y0: torch.Tensor, dy: Callable[[Coeffs, Coeffs, int], torch.Tensor]
                ) -> Coeffs:
    """y with y' = z x', z_m = dy(y, yy, m) built from y's coefficients
    0..m and the Cauchy square yy of y: tanh (z = 1 - y^2) and the
    logistic sigmoid (z = y - y^2)."""
    y, z = [y0], []
    for k in range(1, len(x)):
        m = k - 1
        z.append(dy(y, _cauchy(torch.mul, y, y, m), m))
        y.append(_chain(x, z, k))
    return y


def _tanh(a):
    x = _series(a, a.order)
    return _wrap(_square_law(x, torch.tanh(x[0]),
                             lambda y, yy, m: (1.0 - yy) if m == 0 else -yy))


def _sigmoid_series(x: Coeffs) -> Coeffs:
    return _square_law(x, torch.sigmoid(x[0]), lambda y, yy, m: y[m] - yy)


def _sigmoid(a):
    return _wrap(_sigmoid_series(_series(a, a.order)))


def _logaddexp(a, b):
    """y = log(e^a + e^b): y' = s a' + (1 - s) b' with s = sigmoid(a - b)."""
    n = _order(a, b)
    sa, sb = _series(a, n), _series(b, n)
    d = [p - q for p, q in zip(sa, sb)]
    s = _sigmoid_series(d)
    y = [torch.logaddexp(sa[0], sb[0])]
    for k in range(1, n + 1):
        y.append(_chain(d, s, k) + sb[k])
    return _wrap(y)


def _clamp(a, min=None, max=None):
    """Piecewise linear: coefficients above 0 pass where the value lies
    strictly inside the bounds."""
    x = _series(a, a.order)
    inside = torch.ones_like(x[0], dtype=torch.bool)
    if min is not None:
        inside = inside & (x[0] > min)
    if max is not None:
        inside = inside & (x[0] < max)
    return _wrap([torch.clamp(x[0], min=min, max=max)]
                 + [torch.where(inside, xk, torch.zeros_like(xk)) for xk in x[1:]])


def _softmax(a, dim, dtype=None):
    """exp(a - max a_0) over its sum along ``dim``."""
    if dtype is not None:
        raise NotImplementedError("Taylor mode: softmax with dtype=")
    x = _series(a, a.order)
    shift = torch.amax(x[0], dim=dim, keepdim=True)
    e = _exp(Taylor(torch.stack([x[0] - shift] + x[1:])))
    return _div(e, _linear("sum")(e, dim=dim, keepdim=True))


# ---------------------------------------------------------------------------
# selection, concatenation and the constants made from a Taylor
# ---------------------------------------------------------------------------

def _where(cond, a, b):
    if isinstance(cond, Taylor):
        raise NotImplementedError("Taylor mode: where with a Taylor condition")
    n = _order(a, b)
    sa, sb = _series(a, n), _series(b, n)
    return _wrap([torch.where(cond, x, y) for x, y in zip(sa, sb)])


def _cat(tensors, dim=0):
    n = _order(tensors)
    cols = [_series(t, n) for t in tensors]
    return _wrap([torch.cat([c[k] for c in cols], dim=dim) for k in range(n + 1)])


def _constant_like(f: Callable) -> Callable:
    """``full_like``/``zeros_like``/``ones_like`` of a Taylor: a constant
    shaped like its value."""
    def rule(a, *args, **kwargs):
        return f(a.coeffs[0].detach(), *args, **kwargs)
    return rule


_RULES: Dict[str, Callable] = {}
for _names, _rule in (
        (("add", "__add__", "__radd__"), _add),
        (("sub", "__sub__"), _sub),
        (("rsub", "__rsub__"), _rsub),
        (("neg", "__neg__"), _neg),
        (("mul", "__mul__", "__rmul__"), _mul),
        (("div", "__truediv__"), _div),
        (("__rtruediv__", "__rdiv__"), _rdiv),
        (("pow", "__pow__"), _pow),
        (("matmul", "__matmul__"), _matmul),
        (("__rmatmul__",), _rmatmul),
        (("einsum",), _einsum),
        (("exp",), _exp),
        (("log",), _log),
        (("sin",), _sin),
        (("cos",), _cos),
        (("tanh",), _tanh),
        (("sigmoid",), _sigmoid),
        (("rsqrt",), _rsqrt),
        (("sqrt",), _sqrt),
        (("logaddexp",), _logaddexp),
        (("clamp",), _clamp),
        (("softmax",), _softmax),
        (("where",), _where),
        (("cat",), _cat),
        (("full_like",), _constant_like(torch.full_like)),
        (("zeros_like",), _constant_like(torch.zeros_like)),
        (("ones_like",), _constant_like(torch.ones_like)),
        (("sum",), _linear("sum")),
        (("mean",), _linear("mean")),
        (("reshape",), _linear("reshape")),
        (("__getitem__",), _linear("__getitem__"))):
    for _name in _names:
        _RULES[_name] = _rule


# ---------------------------------------------------------------------------
# the oracle's entry point
# ---------------------------------------------------------------------------

def seed(x: torch.Tensor, tangent: torch.Tensor | None, order: int) -> Taylor:
    """The input curve ``x + t v`` to ``order``: series ``(v, 0, ..., 0)``."""
    if tangent is None:
        tangent = torch.ones_like(x)
    zeros = torch.zeros((order - 1,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    return Taylor(torch.cat([x[None], tangent.to(x.dtype)[None], zeros]))


def raw_derivatives(y) -> torch.Tensor:
    """(n+1, *shape) raw derivatives ``k! c_k`` of a Taylor output."""
    n = y.order
    facts = torch.tensor([float(math.factorial(k)) for k in range(n + 1)],
                         dtype=y.coeffs.dtype, device=y.coeffs.device)
    return y.coeffs * facts.reshape((-1,) + (1,) * (y.coeffs.ndim - 1))


def taylor_derivatives(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                       order: int, tangent: torch.Tensor | None = None) -> torch.Tensor:
    """(order+1, *fn(x).shape) raw derivatives ``d^k/dt^k fn(x + t v)`` at
    t = 0, by Taylor mode through ``fn``'s torch operations (``v`` defaults
    to ones).  An output that does not depend on ``x`` has zero
    derivatives."""
    if order == 0:
        return fn(x)[None]
    y = fn(seed(x, tangent, order))
    if not isinstance(y, Taylor):
        return torch.cat([y[None], torch.zeros((order,) + tuple(y.shape), dtype=y.dtype,
                                               device=y.device)])
    return raw_derivatives(y)
