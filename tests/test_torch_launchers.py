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


def test_runtime_scores_launcher_takes_the_geometry_after_the_scale():
    """The run-time K5 launcher takes the templated launcher's arguments:
    (groups, split, tiles, ring) after the scale, groups 0 naming the
    smallest block (tests/test_torch_scores.py checks the values)."""
    names = [pname for _, pname in _launcher_params()["jet_attention_scores_rt_launch"]]
    assert names == [pname for _, pname in _launcher_params()["jet_attention_scores_launch"]]


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


# ---------------------------------------------------------------------------
# the run-time-order K3 and K4 blocks (csrc/jet_runtime.cu): what each
# lane takes, following the kernels' index arithmetic, and what is admitted
# ---------------------------------------------------------------------------

def _parent_admits_flash(n1, dh, dm, dtype):
    """The run-time K4 before its short- and long-T blocks: one warp of
    2 n1 Dh + n1 Dm + 3 n1 words."""
    return (2 * n1 * dh + n1 * dm + 3 * n1) * tk2.compute_itemsize(dtype) <= tka._SMEM_LIMIT


def _parent_admits_rms(n1, dtype):
    """The run-time K3 before its groups of lanes: one warp of 2 n1 words."""
    return 2 * n1 * tk2.compute_itemsize(dtype) <= tka._SMEM_LIMIT


@pytest.mark.parametrize("n1,bsz,width,dtype,aligned", [
    (11, 2048, 32, torch.float64, True), (11, 37, 24, torch.float64, True),
    (5, 70, 32, torch.bfloat16, True), (17, 9, 100, torch.float32, True),
    (11, 5, 1, torch.float64, True), (11, 64, 32, torch.float64, False),
    (1200, 3, 32, torch.float64, True), (10, 300, 45, torch.bfloat16, True)])
def test_runtime_rms_norm_lanes_cover_every_row_and_column_once(n1, bsz, width, dtype,
                                                                 aligned):
    """K3's run-time block as its index arithmetic reads: lanes gl of slot
    warp * (32 / group) + lane / group take the row's vec-element chunks
    gl, gl + group, ...; every (row, column) of the stack is taken exactly
    once, vectors only where the row splits into whole 16 bytes, and the
    block fits."""
    geo = tka.rms_norm_geometry(n1, bsz, width, dtype, aligned)
    size = torch.empty((), dtype=dtype).element_size()
    assert geo.smem <= tka._SMEM_LIMIT and 1 <= geo.warps <= 8
    assert geo.vec in (1, 16 // size) and (geo.vec == 1 or (aligned and width % geo.vec == 0))
    assert geo.staged or geo.group == 32   # an unstaged row takes a warp of its own
    rpw, chunks = 32 // geo.group, -(-width // geo.vec)
    taken = []
    for block in range(-(-bsz // (geo.warps * rpw))):
        for warp in range(geo.warps):
            for lane in range(32):
                slot, gl = warp * rpw + lane // geo.group, lane % geo.group
                row = block * geo.warps * rpw + slot
                if row < bsz:
                    taken += [(row, ch * geo.vec + i) for ch in range(gl, chunks, geo.group)
                              for i in range(geo.vec)]
    assert sorted(taken) == [(r, c) for r in range(bsz) for c in range(width)]


def _short_items(geo, bsz, heads, t, dh):
    """(row, head, query) -> the head dims each lane of its group takes,
    following the short-T kernel's index arithmetic: a block's rows x heads
    (row, head) teams, 32 / team a warp, a team's T groups of lanes."""
    team = (1 << (t - 1).bit_length()) * geo.group
    tpw = 32 // team
    warps = -(-geo.rows * heads // tpw)
    assert 1 <= warps <= 8
    dims = {}
    for block in range(-(-bsz // geo.rows)):
        for warp in range(warps):
            for lane in range(32):
                unit, tl = warp * tpw + lane // team, lane % team
                qi, gl = divmod(tl, geo.group)
                slot, h = divmod(unit, heads)
                b = block * geo.rows + slot
                if slot < geo.rows and b < bsz and qi < t:
                    dims.setdefault((b, h, qi), []).extend(range(gl, dh, geo.group))
    return dims, warps


def _projection_stores(geo, warps, bsz, t, n1, dm, f64):
    """What the short-T kernel's projection stores: f64 as mma.sync m8n8k4
    fragments (lane l: C[l / 4][2 (l % 4) + {0, 1}], 4 tiles of 8 columns
    a warp), f32 as 4 row groups x 8 column lanes, 4 x 4 a thread."""
    mrows = geo.rows * t * n1
    mpad = -(-mrows // 8) * 8
    stores = []
    for block in range(-(-bsz // geo.rows)):
        b0 = block * geo.rows

        def store(row, n):
            item, m = divmod(row, n1)
            ir, iq = divmod(item, t)
            if row < mrows and b0 + ir < bsz and n < dm:
                stores.append((m, b0 + ir, iq, n))

        for warp in range(warps):
            for lane in range(32):
                if f64:
                    n_groups = -(-dm // 32)
                    for tile in range(warp, mpad // 8 * n_groups, warps):
                        mt, ng = divmod(tile, n_groups)
                        for j in range(4):
                            n = ng * 32 + 8 * j + 2 * (lane & 3)
                            store(mt * 8 + (lane >> 2), n)
                            store(mt * 8 + (lane >> 2), n + 1)
                else:
                    for n0 in range(0, dm, 32):
                        for row0 in range((warp * 4 + (lane >> 3)) * 4, mrows, warps * 16):
                            for rr in range(4):
                                for j in range(4):
                                    store(row0 + rr, n0 + (lane & 7) + 8 * j)
    return stores


@pytest.mark.parametrize("n1,bsz,heads,t,dh,dm,dtype", [
    (11, 1024, 2, 2, 16, 32, torch.float64), (11, 37, 2, 3, 20, 7, torch.float64),
    (5, 9, 2, 4, 8, 16, torch.bfloat16), (17, 13, 3, 1, 1, 5, torch.float32),
    (5, 5, 2, 3, 160, 40, torch.float32), (11, 6, 2, 2, 40, 70, torch.float64)])
def test_runtime_flash_short_t_groups_cover_every_query_and_dim_once(n1, bsz, heads, t, dh,
                                                                     dm, dtype):
    """K4's run-time short-T block: every (row, head, query) has one group
    of lanes, whose lanes take each head dim exactly once; the team of a
    (row, head)'s groups fits a warp; the projection stores every output
    exactly once."""
    geo = tka.flash_geometry(n1, heads, t, dh, dtype, dm)
    assert geo.runtime and geo.group > 0 and geo.key_tile == 0
    assert geo.smem == tka.flash_short_bytes(n1, heads, t, dh, dm, geo.rows, dtype) \
        <= tka._SMEM_LIMIT
    per_lane = 8 // tk2.compute_itemsize(dtype)          # head dims a lane: 8 bytes
    assert geo.group == min(1 << (-(-dh // per_lane) - 1).bit_length(),
                            32 // (1 << (t - 1).bit_length()))
    dims, warps = _short_items(geo, bsz, heads, t, dh)
    assert sorted(dims) == [(b, h, q) for b in range(bsz) for h in range(heads)
                            for q in range(t)]
    assert all(sorted(d) == list(range(dh)) for d in dims.values())
    stores = _projection_stores(geo, warps, bsz, t, n1, dm, dtype == torch.float64)
    assert sorted(stores) == [(m, b, q, n) for m in range(n1) for b in range(bsz)
                              for q in range(t) for n in range(dm)]


@pytest.mark.parametrize("n1,bsz,t,dh,dm,dtype", [
    (11, 2, 1024, 8, 16, torch.float64), (11, 3, 70, 8, 20, torch.bfloat16),
    (17, 2, 37, 96, 48, torch.float32), (10, 1, 70, 300, 4, torch.float64)])
def test_runtime_flash_long_t_warps_cover_every_query_once(n1, bsz, t, dh, dm, dtype):
    """K4's run-time long-T block: a block of ``rows`` warps takes as many
    consecutive queries of one row, a tile's keys one a lane, and the
    block fits."""
    geo = tka.flash_geometry(n1, 2, t, dh, dtype, dm)
    assert geo.runtime and geo.group == 0 and 1 <= geo.key_tile <= 32
    assert geo.smem == tka.flash_long_words(n1, dh, dm, geo.rows, geo.key_tile) \
        * tk2.compute_itemsize(dtype) <= tka._SMEM_LIMIT
    qblocks = -(-t // geo.rows)
    taken = [(blk // qblocks, blk % qblocks * geo.rows + w)
             for blk in range(bsz * qblocks) for w in range(geo.rows)
             if blk % qblocks * geo.rows + w < t]
    assert sorted(taken) == [(b, q) for b in range(bsz) for q in range(t)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 1024])
def test_runtime_flash_admits_what_it_admitted_before(t, dtype):
    """No shape the run-time K4's one-warp block admitted is refused now:
    orders from 10 to past the largest the old block took at Dh 8, head
    dims 8 to 1611, Dm 4 and 32.  What no block fits runs the smallest,
    the old one; the short-T block, whose bfloat16 copies take 2 bytes an
    element, admits some shapes the old one refused."""
    item = tk2.compute_itemsize(dtype)
    for dh in (8, 16, 128, 160, 1610, 1611):
        for dm in (4, 32):
            top = tka._SMEM_LIMIT // (item * (2 * dh + dm + 3))
            for n1 in (10, 11, 17, 64, top, top + 1):
                geo = tka.flash_geometry(n1, 2, t, dh, dtype, dm)
                assert geo.runtime
                assert geo.smem <= tka._SMEM_LIMIT or not _parent_admits_flash(n1, dh, dm, dtype)
                if geo.group == 0:      # long T and the smallest block: the same set
                    assert (geo.smem <= tka._SMEM_LIMIT) == _parent_admits_flash(n1, dh, dm,
                                                                                 dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_runtime_rms_norm_admits_what_it_admitted_before(dtype):
    """The run-time K3 admits exactly the orders its one-warp block did
    (2 n1 words): rows too long to stage are read from device memory by a
    block whose rows keep 2 n1 words from n1 = 1056 on."""
    top = tka._SMEM_LIMIT // (2 * tk2.compute_itemsize(dtype))
    for width in (1, 24, 32, 100, 4096):
        for n1 in (10, 11, 17, 64, 1055, 1056, 5000, top, top + 1):
            geo = tka.rms_norm_geometry(n1, 2, width, dtype)
            assert (geo.smem <= tka._SMEM_LIMIT) == _parent_admits_rms(n1, dtype)


# the run-time K4's arithmetic, emulated in plain torch over the batch rows
# (lanes' dims summed where the kernel's butterfly sums them) and held to
# the plain version: the sliding window of csrc/jet_runtime.cu::cauchy_tile,
# the short-T kernel's kept scores and the long-T kernel's online max

_TILE = 4   # csrc/jet_runtime.cu: kTile


def _cauchy_tile(acc, a, b, m0, n1):
    """acc[mm] += sum_{i <= m} a_i b_{m-i}, m = m0 + mm, as the kernel's
    window slides (a, b: sequences of coefficient tensors)."""
    w = [b[m0 + mm] if m0 + mm < n1 else torch.zeros_like(b[0]) for mm in range(_TILE)]
    for i in range(min(m0 + _TILE, n1)):
        acc = [acc[mm] + a[i] * w[mm] for mm in range(_TILE)]
        w = [b[m0 - i - 1] if m0 - i - 1 >= 0 else torch.zeros_like(b[0])] + w[:-1]
    return acc


def _cauchy(a, b, n1):
    out = []
    for m0 in range(0, n1, _TILE):
        acc = _cauchy_tile([torch.zeros_like(a[0] * b[0])] * _TILE, a, b, m0, n1)
        out += acc[:n1 - m0]
    return out


def _exp_jet(s, mx, n1):
    e = [torch.exp(s[0] - mx)]
    for m in range(1, n1):
        e.append(sum(j * s[j] * e[m - j] for j in range(1, m + 1)) / m)
    return e


def _divide(a, tot, n1):
    inv0 = 1.0 / tot[0].clamp_min(1e-37)
    o = []
    for m in range(n1):
        r = a[m]
        for j in range(1, m + 1):
            r = r - tot[j] * o[m - j]
        o.append(r * inv0)
    return o


def _keep(qi, t, mask, window):
    lo = max(0, qi - window + 1) if mask == "local" else 0
    return lo, t if mask == "none" else qi + 1


def _emulate_flash(q, k, v, wo, scale, mask, window, key_tile, warps):
    """The run-time K4 for every query: ``key_tile == 0`` the short-T flow
    (all kept keys at once, their max, no rescale), else the long-T tiles
    of the query's block of ``warps`` queries with the alpha rescale."""
    n1, bsz, heads, t, dh = q.shape
    out = torch.zeros((n1, bsz, t, wo.shape[2]), dtype=q.dtype)
    for qi in range(t):
        lo, hi = _keep(qi, t, mask, window)
        q0 = qi // max(warps, 1) * max(warps, 1)
        blo = _keep(q0, t, mask, window)[0]
        bhi = _keep(min(q0 + warps, t) - 1, t, mask, window)[1]
        for h in range(heads):
            qv = [q[c, :, h, qi] for c in range(n1)]
            score = {j: [x.sum(-1) * scale for x in _cauchy(qv, [k[c, :, h, j]
                                                                 for c in range(n1)], n1)]
                     for j in range(lo, hi)}
            if key_tile == 0:
                tiles = [(lo, hi)]
                mx_run = torch.stack([score[j][0] for j in range(lo, hi)]).amax(0)
            else:
                tiles = [(max(lo, k0), min(hi, k0 + key_tile), k0)
                         for k0 in range(blo, bhi, key_tile)]
                tiles = [tl[:2] for tl in tiles if tl[0] < tl[1]]
            m_run = torch.full((bsz,), -1e30, dtype=q.dtype)
            tot = [torch.zeros(bsz, dtype=q.dtype)] * n1
            acc = [torch.zeros((bsz, dh), dtype=q.dtype)] * n1
            for j0, j1 in tiles:
                if key_tile == 0:
                    m_new, alpha = mx_run, 0.0
                else:
                    m_new = torch.maximum(m_run, torch.stack([score[j][0]
                                                              for j in range(j0, j1)]).amax(0))
                    alpha = torch.exp(m_run - m_new)
                e = {j: _exp_jet(score[j], m_new, n1) for j in range(j0, j1)}
                tot = [alpha * tot[m] + sum(e[j][m] for j in range(j0, j1)) for m in range(n1)]
                acc = [alpha[:, None] * acc[m] if key_tile else acc[m] for m in range(n1)]
                for j in range(j0, j1):
                    part = _cauchy([x[:, None] for x in e[j]], [v[c, :, h, j]
                                                              for c in range(n1)], n1)
                    acc = [acc[m] + part[m] for m in range(n1)]
                m_run = m_new
            o = _divide(acc, [x[:, None] for x in tot], n1)
            for m in range(n1):
                out[m, :, qi] += o[m] @ wo[h]
    return out


@pytest.mark.parametrize("t,mask,window", [(2, "none", 0), (3, "causal", 0), (4, "local", 2),
                                           (1, "none", 0), (11, "none", 0),
                                           (11, "causal", 0), (13, "local", 3)])
def test_runtime_flash_arithmetic_matches_plain_version(t, mask, window):
    """The short-T flow (T <= 4) and the long-T tiles (3 keys a tile, 4
    queries a block, so tiles and blocks split the keys) at order 10 equal
    the plain version within 1e-12 of each order plane's max."""
    from repro_torch.core.modules import attention_mask
    from repro_torch.kernels import ref

    n1, bsz, heads, dh, dm = 11, 3, 2, 5, 4
    g = torch.Generator().manual_seed(40 + t)
    q, k, v = (0.5 * torch.randn((n1, bsz, heads, t, dh), generator=g, dtype=torch.float64)
               for _ in range(3))
    wo = torch.randn((heads, dh, dm), generator=g, dtype=torch.float64) / (heads * dh) ** 0.5
    spec = None if mask == "none" else mask if mask == "causal" else (mask, window)
    want = ref.jet_flash_attention_ref(q, k, v, wo, dh ** -0.5, attention_mask(spec, t, "cpu"))
    key_tile, warps = (0, 0) if t <= tka.SHORT_T_MAX else (3, 4)
    got = _emulate_flash(q, k, v, wo, dh ** -0.5, mask, window, key_tile, warps)
    d = (got - want).abs().reshape(n1, -1).amax(-1)
    assert torch.all(d <= 1e-12 * want.abs().reshape(n1, -1).amax(-1))


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
    geo = tka.rms_norm_geometry(n1, 3, 6, dtype, aligned=x.data_ptr() % 16 == 0)
    assert geo.staged and geo.group * geo.vec >= 6 > geo.group * geo.vec // 2
    assert calls[-1][1][3:] == (3, 6, n1, code, 1e-6, geo.vec, geo.group, geo.warps, 1)
    qkv = torch.zeros((n1, 2, 2, 5, 4), dtype=dtype)
    tops.jet_flash_attention(qkv, qkv, qkv, torch.zeros((8, 3), dtype=dtype), 0.5, "causal")
    assert calls[-1][0] == "jet_flash_attention_rt_launch"
    geo = tka.flash_geometry(n1, 2, 5, 4, dtype, 3)
    assert (geo.group, geo.rows, geo.key_tile) == (0, 8, 32)   # T = 5: the long-T kernel
    assert calls[-1][1][5:] == (2, 2, 5, 4, 3, n1, code, 0.5, 1, 0, 0, 8, 32)
    tops.jet_flash_attention(qkv[:, :, :, :2], qkv[:, :, :, :2], qkv[:, :, :, :2],
                             torch.zeros((8, 3), dtype=dtype), 0.5)
    geo = tka.flash_geometry(n1, 2, 2, 4, dtype, 3)
    # short T, 8 bytes of head dims a lane: 4 (f64) or 8 (f32) (row, head)s a warp
    want = (4, 16, 0) if dtype == torch.float64 else (2, 32, 0)
    assert (geo.group, geo.rows, geo.key_tile) == want
    assert calls[-1][1][5:] == (2, 2, 2, 4, 3, n1, code, 0.5, 0, 0) + want
    tops.jet_attention_scores(qkv[:, :, 0], qkv[:, :, 1], 0.5)
    assert calls[-1][0] == "jet_attention_scores_rt_launch"
    geo = tka.scores_runtime_geometry(n1, 5, 4, dtype, 2)
    # T = 5: the tiled kernel, one 8-query group, one warp, the row in one stage
    assert tuple(geo[:4]) == (1, 1, 1, 1)
    assert calls[-1][1][3:] == (2, 5, 4, n1, code, 0.5, 1, 1, 1, 1)
    assert tops.launch_counts() == {"jet_dense": 1, "act_jet": 1, "jet_rms_norm": 1,
                                    "jet_flash_attention": 2, "jet_attention_scores": 1}


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
