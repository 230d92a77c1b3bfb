"""Differential-operator subsystem: PDE residuals as jet-primitive compositions.

n-TangentProp turns "evaluate u and its derivatives at collocation points"
into one quasilinear jet forward per direction (core/engines.py).  This
module layers a small abstraction on top so a PDE residual is written ONCE
against a derivative table and runs through every
:class:`repro_torch.core.engines.DerivativeEngine` and every jet-traceable
:class:`repro_torch.core.network.Network`:

* ``residual_values(params, op, x, net=..., engine=NTPEngine("cuda"))`` --
  any engine (ntp eager or on the kernels, the autodiff baseline) x any
  network (DenseMLP, MLP, Transformer);
* the same residual applied to an *analytic* function via
  :func:`residual_of_fn` -- which is how each operator's manufactured/exact
  solution becomes a test oracle (method of manufactured solutions: the
  residual of the exact solution must vanish identically).

The whole surface is vector-valued: an :class:`Operator` carries ``d_out``
(the number of unknown field components) and its residual may return one
equation (``(N,)``) or a stacked system (``(n_eq, N)``).  The
:class:`DerivTable` indexes components -- ``d(axis, k, comp=c)`` and
``d.mixed(*axes, comp=c)`` -- with ``comp=0`` the default so every scalar
residual reads exactly as the math.

An :class:`Operator` declares its input dimension, the highest pure-
derivative order it consumes, the mixed partials it needs (``mixed``, a
tuple of axis tuples -- served through polarization, ``engine.cross``), a
residual ``R(x, d)``, and an exact solution over its default domain box
(shape (N,) for scalar operators, (N, d_out) for systems).  Registered:

===================  ====  =====  =====  =================================
name                 d_in  d_out  order  residual
===================  ====  =====  =====  =================================
heat                  2     1      2     u_t - nu u_xx
wave                  2     1      2     u_tt - c^2 u_xx
kdv                   2     1      3     u_t + 6 u u_x + u_xxx
allen-cahn            2     1      2     u_t - eps u_xx + u^3 - u - f(t, x)
poisson2d             2     1      2     u_xx + u_yy - f(x, y)
advection-diffusion   3     1      2     u_t + a.grad u - div(D grad u) - f,
                                         rotated anisotropic D (u_xy term)
navier-stokes         2     1      4     steady streamfunction-vorticity:
                                         nu lap^2 psi + psi_y d_x(lap psi)
                                         - psi_x d_y(lap psi) - f
                                         (psi_xxyy via 4th-order
                                         polarization)
gray-scott            2     2      2     coupled reaction-diffusion system,
                                         one residual per component
burgers               1     1      1     -lam u + ((1 + lam) x + u) u'
                                         (self-similar ODE)
===================  ====  =====  =====  =================================

New PDEs register with :func:`register`.  Exact solutions and forcings are
the reference's formulas in torch; the Burgers profile stays numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engines import DerivativeEngine, NTPEngine
from repro_torch.core.network import DenseMLP, Network
from repro_torch.core.ntp import MLPParams


class DerivTable:
    """Pointwise derivative lookup handed to ``Operator.residual``.

    ``d(axis, k, comp=c)`` -> (N,) raw k-th pure derivative of component
    ``c`` of u along input ``axis``; ``d.mixed(*axes, comp=c)`` -> (N,)
    mixed partial for an axis tuple the operator declared in
    ``Operator.mixed`` (order within the tuple is irrelevant: partials
    commute for smooth networks).  ``comp`` defaults to 0, so scalar
    residuals never mention it; systems (d_out > 1) address each unknown
    field by its component index.

    ``pure`` is stored with a trailing component axis (d_in, order+1, N,
    d_out); a rank-3 tensor is promoted to a single component, and mixed
    entries of shape (N,) likewise.
    """

    def __init__(self, pure: torch.Tensor,
                 mixed: Dict[Tuple[int, ...], torch.Tensor] | None = None):
        if pure.ndim == 3:
            pure = pure[..., None]
        self._pure = pure               # (d_in, order+1, N, d_out)
        self._mixed = {k: (v[:, None] if v.ndim == 1 else v)
                       for k, v in (mixed or {}).items()}

    @property
    def n_components(self) -> int:
        return self._pure.shape[-1]

    def _check_comp(self, comp: int) -> None:
        # torch would raise on an out-of-range index too, but a negative
        # comp would silently serve the last component (wrong physics)
        if not 0 <= comp < self.n_components:
            raise IndexError(
                f"comp={comp} out of range for a table with "
                f"{self.n_components} component(s)")

    def __call__(self, axis: int, k: int, comp: int = 0) -> torch.Tensor:
        self._check_comp(comp)
        d_in, orders = self._pure.shape[:2]
        if not (0 <= axis < d_in and 0 <= k < orders):
            raise IndexError(
                f"d(axis={axis}, k={k}) out of range for a table over "
                f"d_in={d_in} axes and orders 0..{orders - 1}")
        return self._pure[axis, k, :, comp]

    def mixed(self, *axes: int, comp: int = 0) -> torch.Tensor:
        self._check_comp(comp)
        key = tuple(sorted(axes))
        if key not in self._mixed:
            raise KeyError(
                f"mixed partial {key} was not precomputed; declare it in the "
                f"operator's ``mixed=`` field (have: {tuple(self._mixed)})")
        return self._mixed[key][:, comp]


@dataclass(frozen=True)
class Operator:
    """A differential operator with a manufactured/exact solution oracle.

    ``residual(x, d)`` consumes collocation points ``x`` of shape
    (N, d_in) and a :class:`DerivTable`; it returns the pointwise residual --
    (N,) for a single equation, or (n_eq, N) for a multi-equation system
    (one row per equation; losses take the mean square over everything).
    ``d_out`` is the number of unknown field components the residual reads
    from the table (``comp=`` indexing); the solving network must match.
    ``mixed`` lists the axis tuples of every ``d.mixed(...)`` lookup
    the residual performs, so engines can precompute them (one polarization
    batch each).  ``exact(x)`` is the solution the residual vanishes on --
    (N,) for scalar operators, (N, d_out) for systems; it doubles as
    boundary/initial data for training and as the accuracy oracle in tests.
    ``differentiable_exact`` is False when ``exact`` is not a pure torch
    function (the Burgers profile's numpy bisection), which excludes it
    from autodiff-based oracle checks only.
    """

    name: str
    d_in: int
    order: int
    residual: Callable[[torch.Tensor, DerivTable], torch.Tensor]
    exact: Callable[[torch.Tensor], torch.Tensor]
    domain: Tuple[Tuple[float, float], ...]
    description: str = ""
    differentiable_exact: bool = True
    mixed: Tuple[Tuple[int, ...], ...] = ()
    d_out: int = 1


_REGISTRY: Dict[str, Operator] = {}


def register(op: Operator) -> Operator:
    if op.name in _REGISTRY:
        raise ValueError(f"operator {op.name!r} already registered")
    if len(op.domain) != op.d_in:
        raise ValueError(f"operator {op.name!r}: domain rank {len(op.domain)} "
                         f"!= d_in {op.d_in}")
    if op.d_out < 1:
        raise ValueError(f"operator {op.name!r}: d_out must be >= 1")
    for axes in op.mixed:
        if any(a < 0 or a >= op.d_in for a in axes):
            raise ValueError(f"operator {op.name!r}: mixed axes {axes} out of "
                             f"range for d_in={op.d_in}")
    _REGISTRY[op.name] = op
    return op


def get_operator(name: str) -> Operator:
    if name not in _REGISTRY:
        raise KeyError(f"unknown operator {name!r}; known: {operator_names()}")
    return _REGISTRY[name]


def operator_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# residual assembly
# ---------------------------------------------------------------------------

def check_net_matches(net: Network, op: Operator) -> None:
    if net.d_out != op.d_out:
        raise ValueError(
            f"operator {op.name!r} solves for {op.d_out} field component(s) "
            f"but the network has d_out={net.d_out}; build the network with "
            f"d_out={op.d_out}")
    if net.d_in != op.d_in:
        raise ValueError(
            f"operator {op.name!r} lives on d_in={op.d_in} coordinates but "
            f"the network has d_in={net.d_in}")


def build_table(net: Network, params, engine: DerivativeEngine,
                op: Operator, x: torch.Tensor) -> DerivTable:
    """Everything the residual will look up, precomputed in batched engine
    calls: one ``grid`` for pure derivatives plus one polarization ``cross``
    per declared mixed partial.  The component axis rides along for free:
    the grid's trailing ``d_out`` axis becomes the table's ``comp=`` index."""
    check_net_matches(net, op)
    pure = engine.grid(net, params, x, op.order)   # (d_in, n+1, N, d_out)
    mixed = {tuple(sorted(a)): engine.cross(net, params, x, a)   # (N, d_out)
             for a in op.mixed}
    return DerivTable(pure, mixed)


def residual_values(params, op: Operator, x: torch.Tensor, *,
                    net: Network,
                    engine: Union[str, DerivativeEngine] = "ntp"
                    ) -> torch.Tensor:
    """Pointwise residual of ``net`` under ``op``: (N,) for single-equation
    operators, (n_eq, N) for systems."""
    eng = DerivativeEngine.from_spec(engine)
    return op.residual(x, build_table(net, params, eng, op, x))


def exact_values(op: Operator, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``op.exact`` normalized to (N, d_out) on ``x``'s device (exact
    solutions may be numpy-backed and scalar operators return (N,))."""
    vals = op.exact(x)
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals), device=x.device)
    if dtype is not None:
        vals = vals.to(dtype)
    if vals.ndim == 1:
        vals = vals[:, None]
    if tuple(vals.shape) != (x.shape[0], op.d_out):
        raise ValueError(
            f"operator {op.name!r}: exact() returned shape {tuple(vals.shape)}, "
            f"want ({x.shape[0]}, {op.d_out})")
    return vals


# ---------------------------------------------------------------------------
# analytic-function oracles (method of manufactured solutions)
# ---------------------------------------------------------------------------

def autodiff_pure_derivs_fn(fn: Callable[[torch.Tensor], torch.Tensor],
                            x: torch.Tensor, order: int) -> torch.Tensor:
    """(d_in, order+1, N) pure derivatives of any scalar fn((d_in,)) -> ()
    via nested ``torch.func.grad`` towers -- the oracle path for analytic
    solutions."""
    from torch.func import grad, vmap

    def one_axis(v):
        def tower(xi):
            h = lambda t: fn(xi + v * t)
            outs = []
            for _ in range(order + 1):
                outs.append(h)
                h = grad(h)
            t0 = torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.stack([o(t0) for o in outs])

        return vmap(tower)(x)                 # (N, order+1)

    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.stack([one_axis(v) for v in eye]).transpose(1, 2)


def autodiff_mixed_partial_fn(fn: Callable[[torch.Tensor], torch.Tensor],
                              x: torch.Tensor,
                              axes: Tuple[int, ...]) -> torch.Tensor:
    """(N,) mixed partial of a scalar fn((d_in,)) -> () by direct
    ``torch.func.grad`` nesting along the named coordinates (independent of
    polarization, so it oracles :meth:`DerivativeEngine.cross` too)."""
    from torch.func import grad, vmap

    g = fn
    for a in axes:
        g = (lambda gg, aa: lambda xi: grad(gg)(xi)[aa])(g, a)
    return vmap(g)(x)


def residual_of_fn(op: Operator, fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Residual of an arbitrary differentiable function (the MMS oracle:
    ``residual_of_fn(op, exact, x) == 0`` certifies the operator's algebra).

    ``fn`` maps a single point (d_in,) to a scalar for ``d_out == 1``
    operators, or to a (d_out,) vector for systems; each component gets its
    own autodiff tower and the stack fills the table's component axis."""
    comps = [fn] if op.d_out == 1 else \
        [lambda xi, c=c: fn(xi)[c] for c in range(op.d_out)]
    pure = torch.stack([autodiff_pure_derivs_fn(f, x, op.order)
                        for f in comps], dim=-1)
    mixed = {tuple(sorted(a)):
             torch.stack([autodiff_mixed_partial_fn(f, x, a) for f in comps],
                         dim=-1)
             for a in op.mixed}
    return op.residual(x, DerivTable(pure, mixed))


def ntp_pure_derivs(params: MLPParams, x: torch.Tensor, order: int,
                    activation: str = "tanh", impl: str = "torch") -> torch.Tensor:
    """(d_in, order+1, N) raw pure derivatives of the network, one jet batch.
    (Legacy surface; ``engine.grid(net, ...)`` is the generic form.)"""
    net = DenseMLP.from_params(params, activation)
    return NTPEngine(impl).grid(net, params, x, order)[..., 0]


# ---------------------------------------------------------------------------
# registered operators (coefficients chosen so no term degenerates)
# ---------------------------------------------------------------------------

HEAT_NU = 0.5
WAVE_C = 2.0
KDV_C = 4.0           # soliton speed
AC_EPS = 0.4
_PI = float(np.pi)


def _heat_residual(x, d):
    return d(0, 1) - HEAT_NU * d(1, 2)


def _heat_exact(x):
    return torch.exp(-HEAT_NU * x[:, 0]) * torch.sin(x[:, 1])


register(Operator(
    name="heat", d_in=2, order=2,
    residual=_heat_residual, exact=_heat_exact,
    domain=((0.0, 1.0), (-_PI, _PI)),
    description="u_t - nu u_xx;  exact u = exp(-nu t) sin x",
))


def _wave_residual(x, d):
    return d(0, 2) - WAVE_C ** 2 * d(1, 2)


def _wave_exact(x):
    return torch.sin(x[:, 1] - WAVE_C * x[:, 0])


register(Operator(
    name="wave", d_in=2, order=2,
    residual=_wave_residual, exact=_wave_exact,
    domain=((0.0, 1.0), (-_PI, _PI)),
    description="u_tt - c^2 u_xx;  exact u = sin(x - c t)",
))


def _kdv_residual(x, d):
    u = d(0, 0)
    return d(0, 1) + 6.0 * u * d(1, 1) + d(1, 3)


def _kdv_exact(x):
    arg = 0.5 * float(np.sqrt(KDV_C)) * (x[:, 1] - KDV_C * x[:, 0])
    return 0.5 * KDV_C / torch.cosh(arg) ** 2


register(Operator(
    name="kdv", d_in=2, order=3,
    residual=_kdv_residual, exact=_kdv_exact,
    domain=((0.0, 0.4), (-8.0, 8.0)),
    description="u_t + 6 u u_x + u_xxx;  exact single soliton, speed c",
))


def _ac_forcing(x):
    # manufactured solution u* = exp(-t) sin x:
    # u*_t - eps u*_xx + u*^3 - u* = (eps - 2) s + s^3,  s = exp(-t) sin x
    s = torch.exp(-x[:, 0]) * torch.sin(x[:, 1])
    return (AC_EPS - 2.0) * s + s ** 3


def _ac_residual(x, d):
    u = d(0, 0)
    return d(0, 1) - AC_EPS * d(1, 2) + u ** 3 - u - _ac_forcing(x)


def _ac_exact(x):
    return torch.exp(-x[:, 0]) * torch.sin(x[:, 1])


register(Operator(
    name="allen-cahn", d_in=2, order=2,
    residual=_ac_residual, exact=_ac_exact,
    domain=((0.0, 1.0), (-_PI, _PI)),
    description="u_t - eps u_xx + u^3 - u - f;  manufactured u = exp(-t) sin x",
))


def _poisson_residual(x, d):
    # forcing f = -2 sin x sin y, so u = sin x sin y solves u_xx + u_yy = f
    return d(0, 2) + d(1, 2) + 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])


def _poisson_exact(x):
    return torch.sin(x[:, 0]) * torch.sin(x[:, 1])


register(Operator(
    name="poisson2d", d_in=2, order=2,
    residual=_poisson_residual, exact=_poisson_exact,
    domain=((0.0, _PI), (0.0, _PI)),
    description="u_xx + u_yy - f;  exact u = sin x sin y (zero on the boundary)",
))


# -- advection-diffusion with a rotated anisotropic diffusion tensor --------
#
# u_t + a . grad u - div(D grad u) = f on (t, x, y), where D = R V R^T with
# rotation R(theta) and principal diffusivities V = diag(nu1, nu2).  In the
# unrotated frame div(D grad u) = d11 u_xx + 2 d12 u_xy + d22 u_yy, so the
# residual has a *genuine mixed-partial term*, served by polarization
# (engine.cross).

AD_THETA = _PI / 6.0
AD_NU = (0.3, 0.1)
AD_VEL = (0.7, -0.4)

_c, _s = float(np.cos(AD_THETA)), float(np.sin(AD_THETA))
AD_D11 = AD_NU[0] * _c ** 2 + AD_NU[1] * _s ** 2
AD_D22 = AD_NU[0] * _s ** 2 + AD_NU[1] * _c ** 2
AD_D12 = (AD_NU[0] - AD_NU[1]) * _s * _c


def _ad_exact(x):
    return torch.exp(-x[:, 0]) * torch.sin(x[:, 1]) * torch.sin(x[:, 2])


def _ad_forcing(x):
    # u* = exp(-t) sin x sin y:  u*_t = -u*, u*_xx = u*_yy = -u*,
    # u*_xy = exp(-t) cos x cos y
    e = torch.exp(-x[:, 0])
    u = e * torch.sin(x[:, 1]) * torch.sin(x[:, 2])
    return (-u
            + AD_VEL[0] * e * torch.cos(x[:, 1]) * torch.sin(x[:, 2])
            + AD_VEL[1] * e * torch.sin(x[:, 1]) * torch.cos(x[:, 2])
            + (AD_D11 + AD_D22) * u
            - 2.0 * AD_D12 * e * torch.cos(x[:, 1]) * torch.cos(x[:, 2]))


def _ad_residual(x, d):
    adv = AD_VEL[0] * d(1, 1) + AD_VEL[1] * d(2, 1)
    diff = AD_D11 * d(1, 2) + 2.0 * AD_D12 * d.mixed(1, 2) + AD_D22 * d(2, 2)
    return d(0, 1) + adv - diff - _ad_forcing(x)


register(Operator(
    name="advection-diffusion", d_in=3, order=2,
    residual=_ad_residual, exact=_ad_exact,
    domain=((0.0, 1.0), (-_PI, _PI), (-_PI, _PI)),
    mixed=((1, 2),),
    description="u_t + a.grad u - div(D grad u) - f, D rotated by pi/6 "
                "(cross term 2 d12 u_xy);  manufactured u = exp(-t) sin x sin y",
))


def burgers_operator(lam: float = 0.5, k: int = 1,
                     domain: float = 2.0) -> Operator:
    """Self-similar Burgers profile ODE (paper eq. 7) as a registry operator.

    The specialized trainer (losses.burgers_pinn_loss) keeps its learnable-
    lambda objective; this fixed-lambda form slots the same residual into the
    generic operator surface.  Exact profile inverts X = -U - U^{2k+1} by
    bisection (numpy), hence ``differentiable_exact=False``.
    """
    def residual(x, d):
        u = d(0, 0)
        return -lam * u + ((1.0 + lam) * x[:, 0] + u) * d(0, 1)

    def exact(x):
        from .burgers import exact_profile
        vals = exact_profile(x[:, 0].detach().cpu().numpy(), k)
        return torch.as_tensor(vals, dtype=x.dtype, device=x.device)

    return Operator(
        name="burgers", d_in=1, order=1, residual=residual, exact=exact,
        domain=((-domain, domain),),
        description="-lam u + ((1+lam) X + u) u';  exact implicit profile",
        differentiable_exact=False,
    )


# -- steady Navier-Stokes in streamfunction-vorticity form ------------------
#
# Eliminating pressure and enforcing incompressibility exactly via the
# streamfunction (u, v) = (psi_y, -psi_x) turns 2-D steady Navier-Stokes
# into ONE scalar 4th-order equation:
#
#     nu lap^2 psi + psi_y d_x(lap psi) - psi_x d_y(lap psi) = f
#
# with lap^2 psi = psi_xxxx + 2 psi_xxyy + psi_yyyy.  The psi_xxyy term is a
# 4th-order mixed partial (16 directional order-4 jets by polarization);
# d_x/d_y of the Laplacian add third-order mixed terms psi_xyy and psi_xxy
# (8 order-3 jets each).

NS_NU = 0.5
NS_A = 0.3


def _ns_psi(xi):
    # mixes Laplacian eigenfunctions with different eigenvalues (-2 and -5);
    # a single eigenfunction would make the advection Jacobian
    # J(psi, lap psi) vanish identically and leave the nonlinearity untested.
    # xi is one point (d_in,) or a batch (N, d_in).
    return (torch.sin(xi[..., 0]) * torch.sin(xi[..., 1])
            + NS_A * torch.sin(2.0 * xi[..., 0]) * torch.sin(xi[..., 1]))


def _ns_forcing(x):
    # closed-form forcing for psi* = s1 + a s2 with s1 = sin x sin y
    # (lap s1 = -2 s1) and s2 = sin 2x sin y (lap s2 = -5 s2):
    #   lap^2 psi* = 4 s1 + 25 a s2
    #   d_x lap psi* = -2 cos x sin y - 10 a cos 2x sin y
    #   d_y lap psi* = -2 sin x cos y -  5 a sin 2x cos y
    a = NS_A
    sx, cx = torch.sin(x[:, 0]), torch.cos(x[:, 0])
    sy, cy = torch.sin(x[:, 1]), torch.cos(x[:, 1])
    s2x, c2x = torch.sin(2.0 * x[:, 0]), torch.cos(2.0 * x[:, 0])
    psi_x = cx * sy + 2.0 * a * c2x * sy
    psi_y = sx * cy + a * s2x * cy
    lap_x = -2.0 * cx * sy - 10.0 * a * c2x * sy
    lap_y = -2.0 * sx * cy - 5.0 * a * s2x * cy
    bih = 4.0 * sx * sy + 25.0 * a * s2x * sy
    return NS_NU * bih + psi_y * lap_x - psi_x * lap_y


def _ns_residual(x, d):
    psi_x, psi_y = d(0, 1), d(1, 1)
    lap_x = d(0, 3) + d.mixed(0, 1, 1)           # d/dx lap psi
    lap_y = d.mixed(0, 0, 1) + d(1, 3)           # d/dy lap psi
    bih = d(0, 4) + 2.0 * d.mixed(0, 0, 1, 1) + d(1, 4)
    return NS_NU * bih + psi_y * lap_x - psi_x * lap_y - _ns_forcing(x)


def _ns_exact(x):
    return _ns_psi(x)


register(Operator(
    name="navier-stokes", d_in=2, order=4,
    residual=_ns_residual, exact=_ns_exact,
    domain=((0.0, _PI), (0.0, _PI)),
    mixed=((0, 0, 1), (0, 1, 1), (0, 0, 1, 1)),
    description="steady Navier-Stokes, streamfunction form: nu lap^2 psi "
                "+ psi_y d_x(lap psi) - psi_x d_y(lap psi) - f;  manufactured "
                "psi = sin x sin y + 0.3 sin 2x sin y",
))


# -- Gray-Scott reaction-diffusion: the first d_out = 2 system --------------
#
#     u_t = Du u_xx - u v^2 + F (1 - u)        + f_u
#     v_t = Dv v_xx + u v^2 - (F + kappa) v    + f_v
#
# on (t, x).  Two coupled unknown fields solved by ONE d_out=2 network; the
# residual reads each component out of the shared derivative table
# (d(axis, k, comp=...)).  Forcings are manufactured so (u*, v*) below
# solves the system exactly.

GS_DU, GS_DV = 0.16, 0.08
GS_F, GS_KAPPA = 0.9, 0.6


def _gs_exact(x):
    t, s = x[:, 0], x[:, 1]
    u = 1.0 - 0.5 * torch.exp(-t) * torch.sin(s)
    v = 0.8 * torch.exp(-t) * torch.cos(s)
    return torch.stack([u, v], dim=-1)


def _gs_forcing(x):
    # u* = 1 - 0.5 e^-t sin x:  u*_t = u*_xx = 0.5 e^-t sin x
    # v* = 0.8 e^-t cos x:      v*_t = v*_xx = -v*
    t, s = x[:, 0], x[:, 1]
    e = torch.exp(-t)
    u, ut_uxx = 1.0 - 0.5 * e * torch.sin(s), 0.5 * e * torch.sin(s)
    v = 0.8 * e * torch.cos(s)
    f_u = ut_uxx - GS_DU * ut_uxx + u * v ** 2 - GS_F * (1.0 - u)
    f_v = -v + GS_DV * v - u * v ** 2 + (GS_F + GS_KAPPA) * v
    return f_u, f_v


def _gs_residual(x, d):
    u, v = d(0, 0, comp=0), d(0, 0, comp=1)
    f_u, f_v = _gs_forcing(x)
    r_u = (d(0, 1, comp=0) - GS_DU * d(1, 2, comp=0)
           + u * v ** 2 - GS_F * (1.0 - u) - f_u)
    r_v = (d(0, 1, comp=1) - GS_DV * d(1, 2, comp=1)
           - u * v ** 2 + (GS_F + GS_KAPPA) * v - f_v)
    return torch.stack([r_u, r_v])


register(Operator(
    name="gray-scott", d_in=2, d_out=2, order=2,
    residual=_gs_residual, exact=_gs_exact,
    domain=((0.0, 1.0), (-_PI, _PI)),
    description="Gray-Scott reaction-diffusion system (2 coupled fields, "
                "one d_out=2 network);  manufactured u = 1 - 0.5 e^-t sin x, "
                "v = 0.8 e^-t cos x",
))


register(burgers_operator())
