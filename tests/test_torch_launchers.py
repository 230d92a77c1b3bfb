"""What the kernels' Python side decides, checked without a card: the
ctypes signatures (argument counts and types) against the CUDA launchers'
C declarations, what the dense-path wrappers hand their launchers (the
launch stubbed, CPU tensors forced down the CUDA branch), and the flash
kernel's tiling (``jet_attention.flash_geometry``) at its limits."""

import importlib
import math
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bell_tables, cuda_lib
from repro_torch.kernels import jet_attention as tka
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tanh_jet as tk2

# the package re-exports a function named `jet_dense`, which shadows the
# submodule as an attribute
tk1 = importlib.import_module("repro_torch.kernels.jet_dense")

_LAUNCHER = re.compile(r'extern "C" int (\w+_launch)\(([^)]*)\)')


def _launchers() -> dict:
    """{name: number of parameters} of every launcher in csrc/*.cu."""
    found = {}
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        for name, params in _LAUNCHER.findall(src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_launcher_has_a_ctypes_signature():
    assert set(_launchers()) == set(cuda_lib._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(name):
    """A ctypes argument list shorter or longer than the C function's shows
    only on the card, as garbage arguments; here it is a count."""
    assert len(cuda_lib._SIGNATURES[name]) == _launchers()[name]


_CTYPES = {"const void*": cuda_lib._P, "void*": cuda_lib._P, "int64_t": cuda_lib._I64,
           "int": cuda_lib._I, "double": cuda_lib._D}


def _launcher_params() -> dict:
    """{name: [(C type, parameter name), ...]} of every launcher."""
    found = {}
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        for name, params in _LAUNCHER.findall(src.read_text()):
            found[name] = [(" ".join(p.split()[:-1]), p.split()[-1])
                           for p in params.split(",") if p.strip()]
    return found


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_ctypes_types_match_the_c_declaration(name):
    """Each argument's ctypes type is the C parameter's: a pointer passed as
    a 32-bit int, or an int64 as an int, is cut on the card."""
    types = tuple(_CTYPES[ctype] for ctype, _ in _launcher_params()[name])
    assert types == cuda_lib._SIGNATURES[name]


def test_scores_launcher_takes_the_geometry_after_the_scale():
    """The K5 wrapper hands (groups, split, tiles, ring) after the
    scale (tests/test_torch_scores.py checks the values it hands)."""
    names = [pname for _, pname in _launcher_params()["jet_attention_scores_launch"]]
    assert names == ["q", "k", "out", "bsz", "t", "d", "n1", "dtype", "scale", "groups",
                     "split", "tiles", "ring", "stream"]


@pytest.fixture
def stubbed(monkeypatch):
    """CPU tensors forced down the CUDA branch, the checks recording what
    they saw, and the launch recording its arguments."""
    seen, calls = {}, []

    def check(t, name, ndim, dtype=None):
        assert t.ndim == ndim and (dtype is None or t.dtype == dtype)
        seen[name] = (tuple(t.shape), t.is_contiguous())

    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    for mod in (tk1, tk2):
        monkeypatch.setattr(mod, "check_cuda_tensor", check)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    tops.reset_launch_counts()
    return seen, calls


@pytest.mark.parametrize("dtype,code", [(torch.float64, 1), (torch.float32, 0)])
def test_dense_wrappers_hand_the_launchers_folded_stacks(stubbed, dtype, code):
    """jet_dense / act_jet reach their launchers with the batch axes folded
    into one, contiguous stacks, the shapes, order and codes the C side
    switches on, and one counted launch each."""
    seen, calls = stubbed
    n1, lead, din, dout = 5, (3, 4), 6, 7
    x = torch.zeros((n1,) + lead + (din,), dtype=dtype).transpose(1, 2)
    w, b = torch.zeros((din, dout), dtype=dtype), torch.zeros(dout, dtype=dtype)
    out = tops.jet_dense(x, w, b, "sigmoid")
    assert out.shape == (n1, 4, 3, dout)
    assert seen["coeffs"] == ((n1, 12, din), True)
    assert seen["w"] == ((din, dout), True) and seen["b"] == ((dout,), True)
    name, args = calls[-1]
    assert name == "jet_dense_launch"
    assert args[4:] == (12, din, dout, n1, 2, code)

    out = tops.jet_dense(x, w, b, None)
    assert calls[-1][1][4:] == (12, din, dout, n1, 0, code)

    y = torch.zeros((n1, 2, 9), dtype=dtype)
    assert tops.act_jet(y, "sin").shape == y.shape
    name, args = calls[-1]
    assert name == "act_jet_launch" and args[2:] == (18, n1, 3, code)
    assert tops.launch_counts() == {"jet_dense": 2, "act_jet": 1,
                                    "jet_rms_norm": 0, "jet_flash_attention": 0,
                                    "jet_attention_scores": 0}


# ---------------------------------------------------------------------------
# flash_geometry: which kernel, which tiles, how much shared memory
# ---------------------------------------------------------------------------

def _short_words(n1, heads, t, dh, rows):
    """The output jets of the block's (row, query) items: rows of an odd
    pitch, their count padded to a multiple of 8 (the projection's m8n8k4
    tiles)."""
    hd = heads * dh
    return -(-rows * t * n1 // 8) * 8 * (hd | 1)


def _long_words(n1, heads, dh, warps, tile):
    return 2 * n1 * tile * (dh + 1) + warps * (heads + 1) * n1 * dh


def test_flash_geometry_served_shape_packs_rows_of_the_short_kernel():
    geo = tka.flash_geometry(5, 2, 2, 16, torch.float64)
    assert geo == tka.FlashGeometry(group=4, rows=16, key_tile=0, dpl=4,
                                    smem=_short_words(5, 2, 2, 16, 16) * 8)
    # every (row, query) has its own group of 4 lanes in a 128-thread block
    assert geo.rows * 2 * geo.group == tka._SHORT_THREADS


@pytest.mark.parametrize("dh,group", [(1, 1), (8, 2), (16, 4), (20, 8), (33, 16),
                                      (64, 16), (96, 32), (128, 32)])
def test_flash_geometry_lanes_cover_the_head_dims(dh, group):
    geo = tka.flash_geometry(3, 2, 1, dh, torch.float32)
    assert (geo.group, geo.dpl) == (group, 4)
    assert geo.group * geo.dpl >= dh
    assert geo.rows * 1 * geo.group <= tka._SHORT_THREADS


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_flash_geometry_short_t_fits_every_query_in_the_block(t):
    geo = tka.flash_geometry(9, 3, t, 16, torch.float64)
    assert geo.group == 4 and geo.rows == 32 // t
    assert geo.smem == _short_words(9, 3, t, 16, geo.rows) * 8 <= tka._SMEM_LIMIT


@pytest.mark.parametrize("t", [5, 70, 1024])
def test_flash_geometry_long_t_takes_the_tiled_kernel(t):
    geo = tka.flash_geometry(3, 2, t, 8, torch.float32)
    assert geo == tka.FlashGeometry(group=0, rows=8, key_tile=32, dpl=1,
                                    smem=_long_words(3, 2, 8, 8, 32) * 4)


def test_flash_geometry_shrinks_tile_then_warps_to_fit():
    # Dh 128, order 8, f64: a 32-key tile of K and V alone is 594 KB
    geo = tka.flash_geometry(9, 2, 70, 128, torch.float64)
    assert geo.group == 0 and geo.dpl == 4
    assert geo.smem == _long_words(9, 2, 128, geo.rows, geo.key_tile) * 8
    assert geo.smem <= tka._SMEM_LIMIT
    assert geo.key_tile == 8 and geo.rows == 2
    # short T falls back to the long kernel once even one row is too big
    big = tka.flash_geometry(9, 40, 2, 128, torch.float64)
    assert big.group == 0


def test_flash_geometry_edge_of_what_the_wrapper_admits(monkeypatch):
    """The largest head count that fits at Dh 128, order 8, f64 is
    admitted; one more is refused by the wrapper, naming the limit."""
    fits = [h for h in range(1, 64)
            if tka.flash_smem_bytes(9, h, 70, 128, torch.float64) <= tka._SMEM_LIMIT]
    edge = max(fits)
    assert fits == list(range(1, edge + 1))
    over = tka.flash_geometry(9, edge + 1, 70, 128, torch.float64)
    assert over.smem > tka._SMEM_LIMIT and over.rows == 1 and over.key_tile == 1
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a: None)
    q = torch.zeros((9, 1, edge + 1, 70, 128), dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        tka.jet_flash_attention_cuda(q, q, q, torch.zeros((edge + 1, 128, 4),
                                                          dtype=torch.float64), 0.1)


@pytest.mark.parametrize("dtype,n1", [(torch.bfloat16, 5), (torch.float64, 11),
                                      (torch.float32, 17)])
def test_runtime_path_reaches_its_launchers(stubbed, monkeypatch, dtype, n1):
    """Orders past the templates and bfloat16 reach the run-time-order
    launchers (csrc/jet_runtime.cu) with the tables of order n1 - 1, the
    block the wrapper sized, and one counted launch each; the templates'
    launchers see none of them."""
    seen, calls = stubbed
    monkeypatch.setattr(tka, "check_cuda_tensor", lambda *a, **k: None)
    code = tk2.DTYPE_CODES[dtype]
    x = torch.zeros((n1, 3, 6), dtype=dtype)
    w, b = torch.zeros((6, 7), dtype=dtype), torch.zeros(7, dtype=dtype)
    ints, reals = tk2.device_tables(n1 - 1, "cpu")
    tables = (ints.data_ptr(), reals.data_ptr(), ints.numel(), reals.numel())
    geo = tk2.jet_dense_geometry(n1, dtype, 3, 6, 7, "tanh")
    tops.jet_dense(x, w, b, "tanh")
    assert calls[-1][0] == "jet_dense_rt_launch"
    assert calls[-1][1][4:] == ((3, 6, 7, n1, 1, code) + tables
                                + (geo.tile, geo.kc, geo.warps, int(geo.staged)))
    geo = tk2.act_jet_geometry(n1, dtype, 18)
    tops.act_jet(x, "sin")
    assert calls[-1][0] == "act_jet_rt_launch"
    assert calls[-1][1][2:] == ((18, n1, 3, code) + tables
                                + (geo.tile, geo.warps, int(geo.staged)))
    tops.jet_rms_norm(x, torch.ones(6, dtype=dtype))
    assert calls[-1][0] == "jet_rms_norm_rt_launch"
    assert calls[-1][1][3:] == (3, 6, n1, code, 1e-6, 8)
    qkv = torch.zeros((n1, 2, 2, 5, 4), dtype=dtype)
    tops.jet_flash_attention(qkv, qkv, qkv, torch.zeros((8, 3), dtype=dtype), 0.5, "causal")
    assert calls[-1][0] == "jet_flash_attention_rt_launch"
    assert calls[-1][1][5:] == (2, 2, 5, 4, 3, n1, code, 0.5, 1, 0, 8)
    tops.jet_attention_scores(qkv[:, :, 0], qkv[:, :, 1], 0.5)
    assert calls[-1][0] == "jet_attention_scores_rt_launch"
    assert calls[-1][1][3:] == (2, 5, 4, n1, code, 0.5, 8)
    assert tops.launch_counts() == {"jet_dense": 1, "act_jet": 1, "jet_rms_norm": 1,
                                    "jet_flash_attention": 1, "jet_attention_scores": 1}


def _dense_writes(n1, n_elem, lanes, tile_map):
    """The outputs csrc/jet_runtime.cu's dense epilogue stores for one
    tile's elements, following its loops: out_0 a thread an element, then
    each warp a (group of 32 lanes x ``lanes`` elements, slot), a lane's
    elements e0 .. e0 + lanes - 1, each order of the slot.  ``tile_map(e)``
    is the element's (row, column) or None where it lies past the output."""
    orders = bell_tables.order_slots(n1 - 1)
    writes = []
    for e in range(n_elem):
        if tile_map(e) is not None:
            writes.append((0, *tile_map(e)))
    groups = math.ceil(n_elem / (32 * lanes))
    for it in range(groups * len(orders)):
        g, s = divmod(it, len(orders))
        for lane in range(32):
            e0 = (g * 32 + lane) * lanes
            if e0 >= n_elem:
                continue
            for e in range(e0, e0 + lanes):
                if e < n_elem and tile_map(e) is not None:
                    writes += [(k, *tile_map(e)) for k in orders[s]]
    return writes


@pytest.mark.parametrize("n1,bsz,din,dout,dtype,act", [
    (11, 37, 24, 24, torch.float64, "tanh"), (11, 9, 1, 24, torch.float64, "tanh"),
    (11, 300, 24, 1, torch.float64, None), (5, 77, 13, 45, torch.bfloat16, "sin"),
    (17, 70, 32, 32, torch.float32, "sigmoid"), (13, 5, 40, 70, torch.float64, "tanh")])
def test_runtime_dense_kernel_indexing_covers_every_output_once(n1, bsz, din, dout, dtype,
                                                                act):
    """K1's run-time kernel as its loops index, at the geometry the wrapper
    picks: every pre-activation of a tile (plane, row, column) gets exactly
    one GEMM thread, and every output (plane, row, column) is stored
    exactly once, by the direct store without an activation or by the
    epilogue; rows and columns past the output are computed, never
    stored."""
    geo = tk2.jet_dense_geometry(n1, dtype, bsz, din, dout, act)
    rows, cols, row_tile = geo.tile, geo.cols, tk2._ROW_TILE
    nq, nthreads = n1 * rows, 32 * geo.warps
    nqp = math.ceil(nq / row_tile) * row_tile
    items = nqp // row_tile * cols
    col_tiles = math.ceil(dout / cols)
    stores = []
    for t in range(math.ceil(bsz / rows) * col_tiles):
        b0, o0 = t // col_tiles * rows, t % col_tiles * cols
        z = []
        for rnd in range(math.ceil(items / nthreads)):
            for tid in range(nthreads):
                item = rnd * nthreads + tid
                if item >= items:
                    continue
                c, q0 = item % cols, item // cols * row_tile
                for q in range(q0, min(q0 + row_tile, nq)):
                    p, r = divmod(q, rows)
                    z.append((p, r, c))
                    if act is None and b0 + r < bsz and o0 + c < dout:
                        stores.append((p, b0 + r, o0 + c))
        assert sorted(z) == [(p, r, c) for p in range(n1) for r in range(rows)
                             for c in range(cols)]
        if act is not None:
            def tile_map(e, b0=b0, o0=o0):
                r, c = divmod(e, cols)
                return (b0 + r, o0 + c) if b0 + r < bsz and o0 + c < dout else None
            stores += _dense_writes(n1, rows * cols, tk2.lane_elems(dtype), tile_map)
    assert sorted(stores) == [(p, b, o) for p in range(n1) for b in range(bsz)
                              for o in range(dout)]


@pytest.mark.parametrize("n1,n_elem,dtype", [(11, 1000, torch.float64), (5, 77, torch.bfloat16),
                                             (17, 4097, torch.float32), (1, 40, torch.float64)])
def test_runtime_act_kernel_indexing_covers_every_output_once(n1, n_elem, dtype):
    """K2's run-time kernel: tiles of 32 units elements, every output
    (plane, element) stored exactly once."""
    geo = tk2.act_jet_geometry(n1, dtype, n_elem)
    epad = 32 * geo.tile
    stores = []
    for t in range(math.ceil(n_elem / epad)):
        base = t * epad
        elems = min(epad, n_elem - base)
        stores += _dense_writes(n1, elems, tk2.lane_elems(dtype),
                                lambda e, base=base: (base + e, 0))
    assert sorted(stores) == [(p, i, 0) for p in range(n1) for i in range(n_elem)]
