"""The port's op-level analyzer (``repro_torch.launch.op_static``) on the
reference's ``tests/test_hlo_static.py`` cases: each one's dot FLOPs equal
the exact formula and the reference's ``hlo_static.analyze`` of the same
function, jitted; an eager loop counts every trip, as the reference
multiplies a ``while`` body by its trip count.  Then the buffer model
(views, in-place updates, the peak of live temporaries), the op log's
round trip, and, in a child process on fake process groups, a collective's
bytes and a DTensor product counted at its local shape alone."""

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R
from repro.launch.hlo_static import analyze as hlo_analyze
from repro_torch.launch.op_static import OpCounter, analyze, totals_from_log


def _hlo_flops(fn, *args) -> float:
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _torch_loop(a, n):
    x = a
    for _ in range(n):
        x = x @ a
    return x


def _jax_scan(a, n):
    def body(x, _):
        return x @ a, None
    return jax.lax.scan(body, a, None, length=n)[0]


def _torch_nested(a):
    x = a
    for _ in range(3):
        for _ in range(5):
            x = x @ a
    return x


def _jax_nested(a):
    def outer(x, _):
        def inner(y, _):
            return y @ a, None
        return jax.lax.scan(inner, x, None, length=5)[0], None
    return jax.lax.scan(outer, a, None, length=3)[0]


# name: (port function, reference function, argument shapes, exact FLOPs)
CASES = {
    "dot": (lambda a, b: a @ b, lambda a, b: a @ b, ((128, 256), (256, 64)),
            2 * 128 * 256 * 64),
    "loop17": (lambda a: _torch_loop(a, 17), lambda a: _jax_scan(a, 17), ((64, 64),),
               17 * 2 * 64 ** 3),
    "nested5x3": (_torch_nested, _jax_nested, ((32, 32),), 15 * 2 * 32 ** 3),
    "batched": (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                lambda a, b: jnp.einsum("bij,bjk->bik", a, b), ((4, 16, 32), (4, 32, 8)),
                2 * 4 * 16 * 32 * 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dot_flops_equal_formula_and_reference(case):
    fn, jfn, shapes, exact = CASES[case]
    _, totals = analyze(fn, *(torch.zeros(s) for s in shapes))
    assert totals.flops == exact
    assert _hlo_flops(jfn, *(jnp.zeros(s, jnp.float32) for s in shapes)) == exact


def test_bytes_above_the_inputs():
    a = torch.zeros(256, 256)
    _, totals = analyze(lambda a: (a @ a).sum(), a)
    assert totals.bytes > 256 * 256 * 4


def test_views_count_nothing_and_updates_their_update():
    """A view moves nothing; ``index_copy_`` counts 2 x its update's bytes
    (the reference's dynamic-update-slice), not the buffer's."""
    buf, src, idx = torch.zeros(64, 128), torch.ones(2, 128), torch.tensor([3, 7])
    _, views = analyze(lambda: buf.t()[:10].unsqueeze(0).expand(3, 10, 64))
    assert views.bytes == 0 and views.ops == 0
    _, upd = analyze(lambda: buf.index_copy_(0, idx, src))
    assert upd.bytes == 2 * src.numel() * 4


def test_peak_of_live_temporaries():
    """Two 1 MiB temporaries alive together, then freed, then one more:
    the peak is 2 MiB (plus the scalar the last op made)."""
    a = torch.zeros(512, 512)

    def fn():
        x = a + 1
        y = a * 2
        del x, y
        z = a - 1
        return z.sum()

    _, totals = analyze(fn)
    assert 2 * a.nbytes <= totals.peak_bytes < 2 * a.nbytes + 1024


def test_log_round_trip():
    a, b = torch.randn(32, 16, requires_grad=True), torch.randn(8, 32)
    with OpCounter() as counter:
        torch.tanh(b @ a).sum().backward()
    again = totals_from_log(counter.log())
    assert (again.flops, again.bytes, again.ops) == (counter.totals.flops,
                                                     counter.totals.bytes,
                                                     counter.totals.ops)
    assert again.flops == 2 * (2 * 8 * 32 * 16)   # forward and the weight's gradient


def test_fake_group_collectives_and_local_flops(tmp_path):
    """A child on fake process groups: an all-gather over 4 ranks counts 4x
    the local bytes, filed under its mesh dim; a DTensor product on a
    16 x 16 mesh counts the local (256, 2048) x (2048, 512) product alone
    (``FlopCounterMode`` also counts the global one)."""
    out, = R.spawn(1, "fake_collectives", tmp_path, timeout=300)
    gather = out["gather"]
    assert gather.collective_bytes == {"all-gather": 4 * 3 * 5 * 4}
    assert gather.collective_counts == {"all-gather": 1}
    assert gather.collective_dims == {"data": 4 * 3 * 5 * 4}
    assert out["matmul"].flops == 2 * 256 * 2048 * 512
