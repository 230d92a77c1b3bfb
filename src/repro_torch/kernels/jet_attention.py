"""Launch wrappers of the attention kernels: K3, the fused jet RMSNorm
(csrc/jet_rms_norm.cu), K4, the flash-jet attention block
(csrc/jet_flash_attention.cu), and K5, the materializing attention-score
jet (csrc/jet_attention_scores.cu).  They replace the reference's
kernels/jet_attention.py::jet_rms_norm_pallas, ::jet_flash_attention_pallas
and ::jet_attention_scores_pallas.

* :func:`jet_rms_norm_cuda`: (n+1, B, W) stack + (W,) gain -> the
  normalized jet, one warp per row (mean-square convolution, Miller rsqrt
  recurrence, normalizing product and gain in one pass).
* :func:`jet_flash_attention_cuda`: Q/K/V stacks (n+1, B, H, T, Dh) and the
  output projection (H, Dh, Dm) -> the block output jet (n+1, B, T, Dm),
  online softmax over the coefficient axis, no score jet in device memory;
  :func:`flash_geometry` picks its kernel (short or long T) and tiles.
* :func:`jet_attention_scores_cuda`: Q/K stacks (n+1, B, T, D) -> the
  softmaxed score jet (n+1, B, T, T), a warp on 8 queries x 8 keys at a
  time, two passes over the keys (online-max totals, then the
  probabilities), key stages shared by the block's query groups of one
  batch row; :func:`scores_geometry` picks its tiling.  No module
  dispatches it (the trunk runs K4), it backs ``ops.jet_attention_scores``
  and the materializing side of the flash-vs-scores memory comparison.

Their plain versions are :func:`repro_torch.kernels.ref.jet_rms_norm_ref`,
:func:`~repro_torch.kernels.ref.jet_flash_attention_ref` and
:func:`~repro_torch.kernels.ref.jet_attention_scores_ref`.  The kernels
take contiguous float32, float64 and bfloat16 tensors of any order: the
templated kernels above run float32/float64 up to N1 = ``TEMPLATE_N1``
(K4 also up to head dim ``_TEMPLATE_HEAD_DIM``); everything else runs the
run-time-order kernels of csrc/jet_runtime.cu with their jets in shared
memory: K3 a group of lanes a row (:func:`rms_norm_geometry`), K4 the
templates' two geometries (:func:`flash_geometry`), K5 the templates' tiling
with its jets in shared memory (:func:`scores_runtime_geometry`).
A wrapper refuses only a launch whose block does not fit in shared
memory, naming the bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_lib import LaunchCounter
from .tanh_jet import (_SMS, DTYPE_CODES, SMEM_LIMIT, check_cuda_tensor, check_depth,
                       check_fits, compute_itemsize, runtime_path)

MASK_CODES = {"none": 0, "causal": 1, "local": 2}
_TEMPLATE_HEAD_DIM = 128      # csrc/jet_flash_attention.cu: 32 lanes x 4 dims; above, jet_runtime.cu
SHORT_T_MAX = 4               # T up to this runs jet_flash_attention_short_kernel
_SHORT_THREADS = 128          # csrc/jet_flash_attention.cu: kShortThreads
_OS_ROW_TILE = 8              # csrc/jet_flash_attention.cu: kOsRowTile
_LONG_WARPS = 8               # queries per block of jet_flash_attention_long_kernel, at most
_LONG_TILE = 32               # keys per shared-memory tile, at most (one a lane)
_SCORES_MAX_WARPS = 16        # csrc/jet_attention_scores.cu: kMaxWarps (128 registers a thread)
_SCORES_MAX_GROUPS = 4        # query groups a block: more left SMs idle at (4, 1024)
_SCORES_MAX_SPLIT = 8         # warps a query's keys are split between (16 lost at (4, 256))
_SCORES_BLOCKS_WANTED = 128   # ~ one block on each of the 132 SMs
_SMEM_LIMIT = SMEM_LIMIT      # shared memory a block can use on Hopper
_RT_WARPS = 8                 # csrc/jet_runtime.cu: warps of a K3/K4/K5 block, at most
_RT_RESIDENT_WARPS = 16       # K5's tiled kernel, f32/bf16: __launch_bounds__(256, 2)
_RT_RESIDENT_WARPS_F64 = 8    # and f64: __launch_bounds__(256, 1), up to 255 registers
_RMS_CHUNK = 32               # csrc/jet_runtime.cu: kRmsChunk
_KEY_PITCH = 33               # csrc/jet_runtime.cu: kKeyPitch
_SM_SMEM = 233472             # shared memory of one SM; each block reserves 1 KB of it

RMS_NORM_LAUNCHES = LaunchCounter("jet_rms_norm")
FLASH_LAUNCHES = LaunchCounter("jet_flash_attention")
SCORES_LAUNCHES = LaunchCounter("jet_attention_scores")


def _same_device(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"tensors must share a device, got "
                         f"{[str(t.device) for t in ts]}")


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def runtime_warps(words_per_warp: int, dtype: torch.dtype) -> tuple[int, int]:
    """(warps, shared bytes) of a run-time-order block whose warps each keep
    ``words_per_warp`` words (K4's and K5's smallest blocks): up to 8 warps,
    fewer where they do not fit; one warp that does not fit leaves ``smem``
    over the limit."""
    per_warp = words_per_warp * compute_itemsize(dtype)
    warps = max(1, min(_RT_WARPS, _SMEM_LIMIT // per_warp))
    return warps, warps * per_warp


class RmsGeometry(NamedTuple):
    """K3's run-time-order block (csrc/jet_runtime.cu): ``vec`` elements a
    lane loads at once (16 bytes of the stack where rows are 16-byte
    aligned, else 1), ``group`` lanes a row (32 / group rows a warp),
    ``warps``, whether the rows' coefficients are ``staged`` in shared
    memory (else read from device memory), and the block's shared bytes."""
    vec: int
    group: int
    warps: int
    staged: bool
    smem: int


def _tile_bytes(words: int, item: int) -> int:
    """``words`` words of ``item`` bytes, rounded up to 16 bytes
    (csrc/jet_runtime.cu::tile_bytes)."""
    return -(-words * item // 16) * 16


def rms_norm_slot_bytes(n1: int, width: int, group: int, staged: bool, item_s: int,
                        item_t: int) -> int:
    """Bytes of one K3 row slot (csrc/jet_runtime.cu::rms_slot_bytes): when
    ``staged`` the row's coefficients (``item_s`` bytes each, padded to 16
    bytes), then its mean-square jet and the reduction's scratch (up to 32
    coefficients x (group + 1) lanes) that the rsqrt jet reuses, ``item_t``
    bytes each."""
    chunk = min(n1, _RMS_CHUNK)
    return (_tile_bytes(n1 * width, item_s) if staged else 0) \
        + _tile_bytes(n1 + max(n1, chunk * (group + 1)), item_t)


def rms_norm_geometry(n1: int, bsz: int, width: int, dtype: torch.dtype,
                      aligned: bool = True) -> RmsGeometry:
    """The block the K3 launcher runs (a persistent grid of them): lanes
    over 16-byte chunks of a row where ``aligned`` (the stack's rows start
    on 16 bytes), a power-of-two group of lanes covering the row, several
    rows a warp where the row is short, the rows staged in shared memory;
    up to 8 warps, halved while the grid covers the SMs less than twice.
    A row that no warp can stage is read from device memory by a warp of
    its own (32 lanes): that block keeps 2 n1 words a row from n1 = 1056
    on, and past the limit ``smem`` exceeds it and the wrapper refuses."""
    item = compute_itemsize(dtype)
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size if aligned and width * size % 16 == 0 else 1
    group = min(32, _pow2_ceil(-(-width // vec)))
    rpw = 32 // group
    warp = rpw * rms_norm_slot_bytes(n1, width, group, True, size, item)
    warps = min(_RT_WARPS, _SMEM_LIMIT // warp)
    if warps >= 1:
        while warps > 1 and -(-bsz // (warps * rpw)) < 2 * _SMS:
            warps //= 2
        return RmsGeometry(vec, group, warps, True, warps * warp)
    warp = rms_norm_slot_bytes(n1, width, 32, False, size, item)
    warps = max(1, min(_RT_WARPS, _SMEM_LIMIT // warp))
    return RmsGeometry(vec, 32, warps, False, warps * warp)


def jet_rms_norm_cuda(coeffs: torch.Tensor, gamma: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """K3 on the card: (n+1, B, W) + (W,) -> (n+1, B, W)."""
    check_cuda_tensor(coeffs, "coeffs", 3)
    check_cuda_tensor(gamma, "gamma", 1, coeffs.dtype)
    _same_device(coeffs, gamma)
    n1, bsz, width = coeffs.shape
    check_depth(n1)
    if gamma.shape[0] != width:
        raise ValueError(f"gamma shape {tuple(gamma.shape)} != ({width},)")
    out = torch.empty_like(coeffs)
    if runtime_path(n1, coeffs.dtype):
        geo = rms_norm_geometry(n1, bsz, width, coeffs.dtype,
                                coeffs.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        check_fits("jet_rms_norm", geo.smem, f"order {n1 - 1} ({geo.warps} warps)")
        cuda_lib.launch("jet_rms_norm_rt_launch", coeffs.device, coeffs.data_ptr(),
                        gamma.data_ptr(), out.data_ptr(), bsz, width, n1,
                        DTYPE_CODES[coeffs.dtype], float(eps), geo.vec, geo.group,
                        geo.warps, int(geo.staged))
    else:
        cuda_lib.launch("jet_rms_norm_launch", coeffs.device, coeffs.data_ptr(),
                        gamma.data_ptr(), out.data_ptr(), bsz, width, n1,
                        DTYPE_CODES[coeffs.dtype], float(eps))
    RMS_NORM_LAUNCHES.add()
    return out


class FlashGeometry(NamedTuple):
    """K4's tiling for one launch.

    ``dpl > 0``: the templates (csrc/jet_flash_attention.cu), ``dpl`` head
    dims a lane; ``group > 0`` the short-T kernel, ``group`` lanes per
    (row, query), ``rows`` batch rows per block; ``group == 0`` the long-T
    kernel, ``rows`` queries (warps) per block, key tiles of ``key_tile``.
    ``dpl == 0``: the run-time-order kernels (csrc/jet_runtime.cu), the
    same fields: short T with ``group`` lanes a (row, query) and ``rows``
    rows a block, long T with ``rows`` warps and ``key_tile`` keys; with
    neither (``group == key_tile == 0``) the smallest block, a warp per
    query whose lanes stride over any head dim, ``rows`` warps.  ``smem``
    the block's dynamic shared memory in bytes."""
    group: int
    rows: int
    key_tile: int
    dpl: int
    smem: int

    @property
    def runtime(self) -> bool:
        return self.dpl == 0


def os_pitch(hd: int) -> int:
    """Words between the output-jet rows the short-T kernels keep in shared
    memory for their projection: odd, so a warp's row groups hit distinct
    banks (csrc/jet_flash_attention.cu::os_pitch)."""
    return hd if hd % 2 else hd + 1


def flash_runtime_words(n1: int, head_dim: int, dm: int) -> int:
    """Words a warp of K4's smallest run-time block keeps
    (csrc/jet_runtime.cu::flash_words): the query jet and the value
    accumulator of one head, the projected output jet, and the score,
    e-jet and total of the current key."""
    return 2 * n1 * head_dim + n1 * dm + 3 * n1


def flash_short_bytes(n1: int, heads: int, t: int, dh: int, dm: int, rows: int,
                      dtype: torch.dtype) -> int:
    """Bytes of a run-time short-T K4 block of ``rows`` batch rows
    (csrc/jet_runtime.cu::flash_short_bytes): wo and the rows' output jets
    (rows x T x n1 padded to 8, at an odd pitch over heads x Dh) in the
    compute type; every (row, head)'s q, k, v (3 n1 T Dh of the storage
    type, each padded to 16 bytes); per (row, head) its score and e-jets
    (2 T^2 n1) and totals (T n1)."""
    item_t = compute_itemsize(dtype)
    item_s = torch.empty((), dtype=dtype).element_size()
    hd, units = heads * dh, rows * heads
    mrows = -(-rows * t * n1 // 8) * 8
    return (_tile_bytes(hd * dm, item_t) + _tile_bytes(mrows * os_pitch(hd), item_t)
            + units * _tile_bytes(3 * n1 * t * dh, item_s)
            + _tile_bytes(units * (2 * t * t * n1 + t * n1), item_t))


def flash_long_words(n1: int, dh: int, dm: int, warps: int, tile: int) -> int:
    """Words of a run-time long-T K4 block (csrc/jet_runtime.cu::
    flash_long_words): the key and value tiles (n1 x tile x (Dh + 1)), then
    per warp the query jet and accumulator (n1 Dh each), the tile's score
    and e-jets (n1 x 33 each), totals (n1) and projected output (n1 Dm)."""
    return 2 * n1 * tile * (dh + 1) + warps * n1 * (2 * dh + 2 * _KEY_PITCH + 1 + dm)


def _flash_runtime_geometry(n1: int, heads: int, t: int, dh: int, dm: int,
                            dtype: torch.dtype) -> FlashGeometry:
    """The run-time-order K4 block: short T (<= SHORT_T_MAX) takes groups of
    lanes a power of two covering Dh at 8 bytes of the compute type a lane
    (one f64 dim, two f32 ones; at most 32 / T rounded up to a power of
    two), a (row, head)'s T groups a team in one warp, as many rows as
    fill ``_RT_WARPS`` warps with all their heads, halved until the
    block fits; long T
    takes 8 queries a block and 32-key tiles, shrinking the tile to 8, then
    the warps, then the tile again until it fits.  Where neither fits, the
    smallest block (:func:`flash_runtime_words` a warp), which admits what
    the wrapper admitted before either existed."""
    item = compute_itemsize(dtype)
    if t <= SHORT_T_MAX:
        tp = _pow2_ceil(t)
        group = min(_pow2_ceil(-(-dh * item // 8)), 32 // tp)   # 8 bytes of dims a lane
        tpw = 32 // (tp * group)              # (row, head) teams a warp
        rows = max(1, _RT_WARPS * tpw // heads)
        while rows > 1 and flash_short_bytes(n1, heads, t, dh, dm, rows, dtype) > _SMEM_LIMIT:
            rows //= 2
        smem = flash_short_bytes(n1, heads, t, dh, dm, rows, dtype)
        if smem <= _SMEM_LIMIT and -(-rows * heads // tpw) <= _RT_WARPS:
            return FlashGeometry(group, rows, 0, 0, smem)
    else:
        warps, tile = _RT_WARPS, _LONG_TILE

        def long_smem() -> int:
            return flash_long_words(n1, dh, dm, warps, tile) * item

        while long_smem() > _SMEM_LIMIT and tile > 8:
            tile //= 2
        while long_smem() > _SMEM_LIMIT and warps > 1:
            warps //= 2
        while long_smem() > _SMEM_LIMIT and tile > 1:
            tile //= 2
        if long_smem() <= _SMEM_LIMIT:
            return FlashGeometry(0, warps, tile, 0, long_smem())
    warps, smem = runtime_warps(flash_runtime_words(n1, dh, dm), dtype)
    return FlashGeometry(0, warps, 0, 0, smem)


def flash_geometry(n1: int, heads: int, t: int, head_dim: int,
                   dtype: torch.dtype, dm: int = 1) -> FlashGeometry:
    """The tiling the K4 launcher runs for these shapes (the kernels'
    shared-memory formulas, csrc/jet_flash_attention.cu::short_smem_words
    and ::long_smem_words, in bytes).  Orders past the templates, bfloat16
    and head dims past ``_TEMPLATE_HEAD_DIM`` take the run-time-order
    kernels (:func:`_flash_runtime_geometry`; ``dm``, the projection's
    width, counts only there).  Short T
    (<= SHORT_T_MAX, and no more queries than a block has lane groups)
    gives each query a group of
    lanes, 4 head dims a lane, and packs as many batch rows into a
    128-thread block as it has groups; its shared memory holds the rows'
    output jets for the projection.  Long T takes 8 queries a block and
    32-key tiles, shrinking the tile to 8, then the warps, then the
    tile again until the block fits ``_SMEM_LIMIT``.  Past that the
    returned ``smem`` exceeds the limit and the wrapper refuses."""
    if runtime_path(n1, dtype) or head_dim > _TEMPLATE_HEAD_DIM:
        return _flash_runtime_geometry(n1, heads, t, head_dim, dm, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    group = min(32, _pow2_ceil(-(-head_dim // 4)))
    groups = _SHORT_THREADS // group
    if t <= min(SHORT_T_MAX, groups):
        rows = groups // t
        while True:
            mrows = -(-rows * t * n1 // _OS_ROW_TILE) * _OS_ROW_TILE
            smem = mrows * os_pitch(heads * head_dim) * item
            if smem <= _SMEM_LIMIT or rows == 1:
                break
            rows //= 2
        if smem <= _SMEM_LIMIT:
            return FlashGeometry(group, rows, 0, 4, smem)
    dpl = 1 if head_dim <= 32 else 2 if head_dim <= 64 else 4
    warps, tile = _LONG_WARPS, _LONG_TILE

    def long_smem() -> int:
        return (2 * n1 * tile * (head_dim + 1)
                + warps * (heads + 1) * n1 * head_dim) * item

    while long_smem() > _SMEM_LIMIT and tile > 8:
        tile //= 2
    while long_smem() > _SMEM_LIMIT and warps > 1:
        warps //= 2
    while long_smem() > _SMEM_LIMIT and tile > 1:
        tile //= 2
    return FlashGeometry(0, warps, tile, dpl, long_smem())


def flash_smem_bytes(n1: int, heads: int, t: int, head_dim: int,
                     dtype: torch.dtype, dm: int = 1) -> int:
    """Dynamic shared memory of one K4 block (see :func:`flash_geometry`)."""
    return flash_geometry(n1, heads, t, head_dim, dtype, dm).smem


def jet_flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, wo: torch.Tensor, scale: float,
                             mask: str = "none", window: int = 0) -> torch.Tensor:
    """K4 on the card: q/k/v (n+1, B, H, T, Dh), wo (H, Dh, Dm) ->
    (n+1, B, T, Dm).  ``mask`` in {"none", "causal", "local"}; "local"
    attends keys j with ``q - window < j <= q``."""
    check_cuda_tensor(q, "q", 5)
    for name, t in (("k", k), ("v", v)):
        check_cuda_tensor(t, name, 5, q.dtype)
        if t.shape != q.shape:
            raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} vs "
                             f"{name} {tuple(t.shape)}")
    check_cuda_tensor(wo, "wo", 3, q.dtype)
    _same_device(q, k, v, wo)
    n1, bsz, heads, t, dh = q.shape
    check_depth(n1)
    if tuple(wo.shape[:2]) != (heads, dh):
        raise ValueError(f"wo shape {tuple(wo.shape)} incompatible with "
                         f"(H, Dh) = ({heads}, {dh})")
    if mask not in MASK_CODES:
        raise ValueError(f"unknown mask variant {mask!r}")
    if mask == "local" and window < 1:
        raise ValueError(f"local mask needs window >= 1, got {window}")
    dm = wo.shape[2]
    geo = flash_geometry(n1, heads, t, dh, q.dtype, dm)
    check_fits("flash", geo.smem, f"{heads} heads x {dh} dims at order {n1 - 1}")
    out = torch.empty((n1, bsz, t, dm), dtype=q.dtype, device=q.device)
    if geo.runtime:
        cuda_lib.launch("jet_flash_attention_rt_launch", q.device, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), wo.data_ptr(), out.data_ptr(),
                        bsz, heads, t, dh, dm, n1, DTYPE_CODES[q.dtype],
                        float(scale), MASK_CODES[mask], int(window), geo.group,
                        geo.rows, geo.key_tile)
    else:
        cuda_lib.launch("jet_flash_attention_launch", q.device, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), wo.data_ptr(), out.data_ptr(),
                        bsz, heads, t, dh, dm, n1, DTYPE_CODES[q.dtype],
                        float(scale), MASK_CODES[mask], int(window), geo.group,
                        geo.rows, geo.key_tile, geo.dpl)
    FLASH_LAUNCHES.add()
    return out


class ScoresGeometry(NamedTuple):
    """K5's tiling for one launch (csrc/jet_attention_scores.cu).

    A block takes ``groups`` groups of 8 queries of one batch row, each
    group's keys split between ``split`` warps; a stage of keys gives each
    warp ``tiles`` tiles of 8 keys, and the block keeps ``ring`` stages in
    shared memory (``ring == 1``: the whole row in one stage, copied once
    for both passes; else 2).  ``smem`` the block's dynamic shared memory
    in bytes.  The score contraction runs on the tensor cores in f64
    (mma.sync m16n8k4), on FMAs in f32.  The run-time-order kernels
    (csrc/jet_runtime.cu, :func:`scores_runtime_geometry`) take the same
    fields; there ``groups == 0`` is the smallest block, a warp a query,
    ``split`` warps (``tiles`` and ``ring`` 0)."""
    groups: int
    split: int
    tiles: int
    ring: int
    smem: int

    @property
    def whole(self) -> bool:
        return self.ring == 1

    @property
    def smallest(self) -> bool:
        return self.groups == 0


def scores_smem_bytes(n1: int, d: int, groups: int, split: int, tiles: int,
                      ring: int, item: int) -> int:
    """Shared memory of one K5 block in bytes (csrc/jet_attention_scores.cu::
    smem_bytes), elements of ``item`` bytes: the scaled queries, the key
    ring and the merge slots."""
    nch = -(-d // 4)
    return item * (groups * n1 * nch * 32 + ring * n1 * nch * split * tiles * 32
                   + groups * split * 8 * (n1 + 1))


def scores_max_warps(n1: int, dtype: torch.dtype) -> int:
    """Warps a K5 block may have (csrc/jet_attention_scores.cu::max_threads):
    8 for the f64 kernels at N1 >= 8, which take up to 255 registers a
    thread, else 16 (128 registers)."""
    return 8 if dtype == torch.float64 and n1 >= 8 else _SCORES_MAX_WARPS


def scores_geometry(n1: int, t: int, d: int, dtype: torch.dtype,
                    bsz: int) -> ScoresGeometry:
    """The tiling the K5 launcher runs for (n1, bsz, t, d) stacks.

    A block takes as many query groups (up to 4, powers of two) as leave
    the grid ~128 blocks: its groups share each key stage it copies, and
    copying keys from L2 is what a stage waits on.  Its other warps split
    the keys (powers of two, up to 8 and :func:`scores_max_warps`, each
    slice keeping at least two 8-key tiles).  Then the first of these that
    lets an SM hold as many blocks as its registers do (16 warps an SM):
    the whole row in one stage, a ring of two stages of 4, 2, 1 tiles a
    warp; then the same with half the groups, then half the split.  If none
    does, the first that fits one block's limit; past that the returned
    ``smem`` exceeds the limit and the wrapper refuses."""
    item = torch.empty((), dtype=dtype).element_size()
    max_warps = scores_max_warps(n1, dtype)
    qtiles = -(-t // 8)
    groups = _scores_groups(t, bsz)
    split = 1
    while split < min(_SCORES_MAX_SPLIT, max_warps // groups) and qtiles >= 4 * split:
        split *= 2
    candidates = []
    while True:
        for tiles, ring in ((-(-qtiles // split), 1), (4, 2), (2, 2), (1, 2)):
            smem = scores_smem_bytes(n1, d, groups, split, tiles, ring, item)
            candidates.append(ScoresGeometry(groups, split, tiles, ring, smem))
        if groups > 1:
            groups //= 2
        elif split > 1:
            split //= 2
        else:
            break
    for geo in candidates:
        per_sm = max(1, max_warps // (geo.groups * geo.split))
        if per_sm * (geo.smem + 1024) <= _SM_SMEM:
            return geo
    return next((geo for geo in candidates if geo.smem <= _SMEM_LIMIT), candidates[-1])


def _scores_groups(t: int, bsz: int) -> int:
    """Query groups a K5 block starts from: as many (up to 4, powers of two)
    as leave the grid ~128 blocks, since a block's groups share each key
    stage it copies."""
    qtiles = -(-t // 8)
    groups = 1
    while (groups < _SCORES_MAX_GROUPS
           and bsz * -(-qtiles // (2 * groups)) >= _SCORES_BLOCKS_WANTED):
        groups *= 2
    return groups


def scores_runtime_words(n1: int, d: int) -> int:
    """Words a warp of K5's smallest run-time block keeps
    (csrc/jet_runtime.cu::scores_words): its query's jet, the score and
    e-jets of 32 keys (one a lane) and the row's totals."""
    return n1 * d + 65 * n1


def scores_rt_smem_bytes(n1: int, d: int, groups: int, split: int, tiles: int, ring: int,
                         item_s: int, item_t: int) -> int:
    """Shared memory of one tiled run-time K5 block in bytes
    (csrc/jet_runtime.cu::scores_tiled_bytes): the scaled queries as the
    templates keep them, per warp its lanes' score and e-jets (two keys a
    lane), totals and running maxima (5 n1 + 1 words a lane), per group
    its queries' totals and maxima, and 1/m for m < n1, in the compute type
    (``item_t`` bytes); the key ring as the templates keep it, in the
    storage type (``item_s``)."""
    nch = -(-d // 4)
    return (item_t * (groups * n1 * nch * 32 + groups * split * (5 * n1 + 1) * 32
                      + groups * (n1 + 1) * 8 + n1)
            + item_s * ring * n1 * nch * split * tiles * 32)


def _scores_runtime_tilings(t: int, bsz: int):
    """The run-time K5's (groups, split, tiles, ring), in order of preference:
    query groups from as many as ``_scores_groups`` gives down to 1,
    for each every key split (powers of two, each slice keeping at least
    two 8-key tiles) from the most warps a block takes down to 1, for each
    the whole row in one stage, then a ring of two stages of 4, 2, 1 tiles
    a warp."""
    qtiles = -(-t // 8)
    groups = _scores_groups(t, bsz)
    while groups >= 1:
        split = _RT_WARPS // groups
        while split >= 1:
            if split == 1 or qtiles >= 2 * split:
                for tiles, ring in ((-(-qtiles // split), 1), (4, 2), (2, 2), (1, 2)):
                    yield groups, split, tiles, ring
            split //= 2
        groups //= 2


def scores_runtime_geometry(n1: int, t: int, d: int, dtype: torch.dtype,
                            bsz: int) -> ScoresGeometry:
    """The block the run-time K5 launcher runs for (n1, bsz, t, d) stacks
    (orders past the templates, bfloat16): of the tilings
    (``_scores_runtime_tilings``, up to 8 warps) that fit a block, the one that
    keeps the most warps on each SM over the launch's waves (an SM holds as
    many blocks as its shared memory and its registers allow: 16 warps at
    f32/bf16, 8 at f64, whose kernel may take 255 registers a thread), the
    first of those in order.  Where none fits, the
    smallest block (:func:`scores_runtime_words` a warp, ``groups == 0``),
    which admits what the wrapper admitted before the tiled kernel existed;
    past its limit ``smem`` exceeds the limit and the wrapper refuses."""
    item_s, item_t = torch.empty((), dtype=dtype).element_size(), compute_itemsize(dtype)
    qtiles = -(-t // 8)

    resident = _RT_RESIDENT_WARPS_F64 if item_t == 8 else _RT_RESIDENT_WARPS

    def warps_per_sm(geo: ScoresGeometry) -> float:
        warps = geo.groups * geo.split
        per_sm = min(resident // warps, _SM_SMEM // (geo.smem + 1024))
        blocks = bsz * -(-qtiles // geo.groups)
        waves = -(-blocks // (per_sm * _SMS))
        return blocks * warps / (waves * _SMS)

    fits = [ScoresGeometry(*c, scores_rt_smem_bytes(n1, d, *c, item_s, item_t))
            for c in _scores_runtime_tilings(t, bsz)]
    fits = [geo for geo in fits if geo.smem <= _SMEM_LIMIT]
    if fits:
        return max(fits, key=warps_per_sm)
    warps, smem = runtime_warps(scores_runtime_words(n1, d), dtype)
    return ScoresGeometry(0, warps, 0, 0, smem)


def jet_attention_scores_cuda(q: torch.Tensor, k: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """K5 on the card: q/k (n+1, B, T, D) -> the softmaxed score jet
    (n+1, B, T, T), tiled by :func:`scores_geometry` (orders past the
    templates and bfloat16: the run-time-order kernels, tiled by
    :func:`scores_runtime_geometry`)."""
    check_cuda_tensor(q, "q", 4)
    check_cuda_tensor(k, "k", 4, q.dtype)
    if k.shape != q.shape:
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    _same_device(q, k)
    n1, bsz, t, d = q.shape
    check_depth(n1)
    if runtime_path(n1, q.dtype):
        geo = scores_runtime_geometry(n1, t, d, q.dtype, bsz)
        check_fits("score", geo.smem, f"head dim {d} at order {n1 - 1}")
        out = torch.empty((n1, bsz, t, t), dtype=q.dtype, device=q.device)
        cuda_lib.launch("jet_attention_scores_rt_launch", q.device, q.data_ptr(),
                        k.data_ptr(), out.data_ptr(), bsz, t, d, n1,
                        DTYPE_CODES[q.dtype], float(scale), geo.groups, geo.split,
                        geo.tiles, geo.ring)
        SCORES_LAUNCHES.add()
        return out
    geo = scores_geometry(n1, t, d, q.dtype, bsz)
    check_fits("score", geo.smem, f"head dim {d} at order {n1 - 1}")
    if geo.groups * geo.split > scores_max_warps(n1, q.dtype):
        raise ValueError(f"a score kernel block takes at most "
                         f"{scores_max_warps(n1, q.dtype)} warps at order {n1 - 1}")
    out = torch.empty((n1, bsz, t, t), dtype=q.dtype, device=q.device)
    cuda_lib.launch("jet_attention_scores_launch", q.device, q.data_ptr(),
                    k.data_ptr(), out.data_ptr(), bsz, t, d, n1,
                    DTYPE_CODES[q.dtype], float(scale), geo.groups, geo.split,
                    geo.tiles, geo.ring)
    SCORES_LAUNCHES.add()
    return out
