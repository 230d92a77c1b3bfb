"""Registry-driven parity of the port against the JAX package, mirroring
tests/test_parity.py: for EVERY registered module (``module_names()``) and
EVERY registered network (``network_names()``) of the port, ``jet_apply``
under ``impl="cuda"`` -- the kernels' plain versions on these CPU tensors
-- and under ``impl="torch"`` must match the reference's ``impl="jnp"`` at
orders 0..4, masked ``SelfAttention`` and the masked trunk included.

Coverage is asserted from the registries: a module or network registered
in the port (or in the reference) without a case here fails this file.
Parameters come from the reference's ``init`` and cross over through
``repro_torch.bridge``; coefficient stacks are drawn with numpy.  Float64
throughout; tolerance 1e-12 relative to each coefficient's max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jet as JJ
from repro.core import modules as jmod
from repro.core.network import make_network as jmake_network
from repro.core.network import network_names as jnetwork_names
from repro_torch import bridge
from repro_torch.core import jet as TJ
from repro_torch.core import modules as tmod
from repro_torch.core.network import make_network, network_names

ORDERS = (0, 1, 2, 3, 4)
MAX_ORDER = max(ORDERS)
TOL = 1e-12
MASK_VARIANTS = (None, "causal", ("local", 2))

# one case per registered module: M (the modules of a package) -> (module,
# input shape), the shapes of tests/test_parity.py
MODULE_CASES = {
    "dense": lambda M: (M.Dense(5, 4, "tanh"), (3, 5)),
    "activation": lambda M: (M.Activation("sin"), (3, 5)),
    "fourier_features": lambda M: (M.FourierFeatures(2, 4, scale=0.7), (3, 2)),
    "rms_norm": lambda M: (M.RMSNorm(6), (3, 2, 6)),
    "self_attention": lambda M: (M.SelfAttention(6, n_heads=2), (3, 4, 6)),
    "mlp_block": lambda M: (M.MLPBlock(6, 12, "tanh"), (3, 6)),
    "coordinate_embedding": lambda M: (M.CoordinateEmbedding(2, 4), (3, 2)),
    "token_pool": lambda M: (M.TokenPool(), (3, 4, 6)),
    "sequential": lambda M: (M.Sequential((M.Dense(4, 8, "sigmoid"),
                                           M.Dense(8, 2, None))), (3, 4)),
    "residual": lambda M: (M.Residual(M.Dense(6, 6, "tanh")), (3, 6)),
}
NETWORK_KWARGS = {
    "dense": {},
    "mlp": {},
    "residual": {},
    "fourier": {"n_features": 4},
    "transformer": {"n_heads": 2},
}


def _port(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    for k in range(want.shape[0]):
        scale = max(float(np.abs(want[k]).max()), 1e-300)
        assert float(np.abs(got[k] - want[k]).max()) <= TOL * scale, k


def test_every_registered_module_has_a_parity_case():
    assert set(MODULE_CASES) == set(tmod.module_names()) == set(jmod.module_names())


def test_every_registered_network_has_a_parity_case():
    assert set(NETWORK_KWARGS) == set(network_names()) == set(jnetwork_names())


def test_every_mask_kind_has_a_parity_variant():
    swept = {tmod.normalize_attention_mask(m)[0] for m in MASK_VARIANTS}
    assert swept == set(tmod.ATTENTION_MASK_KINDS)


@pytest.fixture(scope="module")
def cases():
    """name -> (port module or network, reference one, port params,
    reference params, a max-order coefficient stack)."""
    cache = {}

    def get(name, network=False, mask=None):
        key = (name, network, mask)
        if key not in cache:
            seed = sum(map(ord, name))
            if network:
                kw = dict(d_in=2, d_out=1, width=8, depth=2, **NETWORK_KWARGS[name])
                if mask is not None:
                    kw["mask"] = mask
                jm, tm, shape = jmake_network(name, **kw), make_network(name, **kw), (4, 2)
            elif mask is not None:
                jm, tm, shape = (jmod.SelfAttention(6, 2, mask), tmod.SelfAttention(6, 2, mask),
                                 (3, 4, 6))
            else:
                jm, shape = MODULE_CASES[name](jmod)
                tm, _ = MODULE_CASES[name](tmod)
            jp = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float64)
            coeffs = np.random.default_rng(seed).normal(size=(MAX_ORDER + 1,) + shape) * 0.5
            cache[key] = (tm, jm, _port(jp), jp, coeffs)
        return cache[key]

    return get


def _sweep(case, order):
    tm, jm, tp, jp, coeffs = case
    c = coeffs[:order + 1]
    want = jm.jet_apply(jp, JJ.Jet(jnp.asarray(c)), impl="jnp").coeffs
    for impl in ("cuda", "torch"):
        _close(tm.jet_apply(tp, TJ.Jet(torch.tensor(c)), impl=impl).coeffs, want)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_module_matches_reference(name, order, cases):
    _sweep(cases(name), order)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(NETWORK_KWARGS))
def test_network_matches_reference(name, order, cases):
    _sweep(cases(name, network=True), order)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mask", MASK_VARIANTS,
                         ids=[str(tmod.normalize_attention_mask(m)) for m in MASK_VARIANTS])
def test_masked_attention_matches_reference(mask, order, cases):
    _sweep(cases("self_attention", mask=mask), order)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mask", MASK_VARIANTS,
                         ids=[str(tmod.normalize_attention_mask(m)) for m in MASK_VARIANTS])
def test_masked_transformer_matches_reference(mask, order, cases):
    _sweep(cases("transformer", network=True, mask=mask), order)
