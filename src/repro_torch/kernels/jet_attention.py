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
run-time-order kernels of csrc/jet_runtime.cu, a warp per row (K3) or per
query (K4, K5) with its jets in shared memory.  A wrapper refuses only a
launch whose block does not fit in shared memory, naming the bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_lib import LaunchCounter
from .tanh_jet import (DTYPE_CODES, SMEM_LIMIT, check_cuda_tensor, check_depth,
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
_SM_SMEM = 233472             # shared memory of one SM; each block reserves 1 KB of it

RMS_NORM_LAUNCHES = LaunchCounter("jet_rms_norm")
FLASH_LAUNCHES = LaunchCounter("jet_flash_attention")
SCORES_LAUNCHES = LaunchCounter("jet_attention_scores")


def _same_device(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"tensors must share a device, got "
                         f"{[str(t.device) for t in ts]}")


def runtime_warps(words_per_warp: int, dtype: torch.dtype) -> tuple[int, int]:
    """(warps, shared bytes) of a K3/K4/K5 run-time-order block whose warps
    each keep ``words_per_warp`` words: up to 8 warps, fewer where they do
    not fit; one warp that does not fit leaves ``smem`` over the limit."""
    per_warp = words_per_warp * compute_itemsize(dtype)
    warps = max(1, min(_RT_WARPS, _SMEM_LIMIT // per_warp))
    return warps, warps * per_warp


def rms_norm_runtime_words(n1: int) -> int:
    """Words a K3 run-time-order warp keeps: the row's mean-square jet and
    its rsqrt jet (csrc/jet_runtime.cu)."""
    return 2 * n1


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
        warps, smem = runtime_warps(rms_norm_runtime_words(n1), coeffs.dtype)
        check_fits("jet_rms_norm", smem, f"order {n1 - 1} ({warps} warps)")
        cuda_lib.launch("jet_rms_norm_rt_launch", coeffs.device, coeffs.data_ptr(),
                        gamma.data_ptr(), out.data_ptr(), bsz, width, n1,
                        DTYPE_CODES[coeffs.dtype], float(eps), warps)
    else:
        cuda_lib.launch("jet_rms_norm_launch", coeffs.device, coeffs.data_ptr(),
                        gamma.data_ptr(), out.data_ptr(), bsz, width, n1,
                        DTYPE_CODES[coeffs.dtype], float(eps))
    RMS_NORM_LAUNCHES.add()
    return out


class FlashGeometry(NamedTuple):
    """K4's tiling for one launch (csrc/jet_flash_attention.cu).

    ``group > 0``: the short-T kernel, ``group`` lanes per (row, query) over
    the head dims, ``rows`` batch rows per block.  ``group == 0``: the
    long-T kernel, ``rows`` queries (warps) per block, key tiles of
    ``key_tile``.  ``dpl`` head dims per lane; ``smem`` the block's dynamic
    shared memory in bytes.  ``dpl == 0``: the run-time-order kernel
    (csrc/jet_runtime.cu), a warp per query whose lanes stride over any
    head dim, ``rows`` warps a block."""
    group: int
    rows: int
    key_tile: int
    dpl: int
    smem: int

    @property
    def runtime(self) -> bool:
        return self.dpl == 0


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def os_pitch(hd: int) -> int:
    """Words between the output-jet rows the short-T kernel keeps in shared
    memory for its projection: odd, so a warp's row groups hit distinct
    banks (csrc/jet_flash_attention.cu::os_pitch)."""
    return hd if hd % 2 else hd + 1


def flash_runtime_words(n1: int, head_dim: int, dm: int) -> int:
    """Words a K4 run-time-order warp keeps (csrc/jet_runtime.cu): the
    query jet and the value accumulator of one head, the projected output
    jet, and the score, e-jet and total of the current key."""
    return 2 * n1 * head_dim + n1 * dm + 3 * n1


def flash_geometry(n1: int, heads: int, t: int, head_dim: int,
                   dtype: torch.dtype, dm: int = 1) -> FlashGeometry:
    """The tiling the K4 launcher runs for these shapes (the kernels'
    shared-memory formulas, csrc/jet_flash_attention.cu::short_smem_words
    and ::long_smem_words, in bytes).  Orders past the templates, bfloat16
    and head dims past ``_TEMPLATE_HEAD_DIM`` take the run-time-order
    kernel, whose block of up to 8 warps keeps :func:`flash_runtime_words`
    a warp (``dm``, the projection's width, counts only there).  Short T
    (<= SHORT_T_MAX, and no more queries than a block has lane groups)
    gives each query a group of
    lanes, 4 head dims a lane, and packs as many batch rows into a
    128-thread block as it has groups; its shared memory holds the rows'
    output jets for the projection.  Long T takes 8 queries a block and
    32-key tiles, shrinking the tile to 8 keys, then the warps, then the
    tile again until the block fits ``_SMEM_LIMIT``.  Past that the
    returned ``smem`` exceeds the limit and the wrapper refuses."""
    if runtime_path(n1, dtype) or head_dim > _TEMPLATE_HEAD_DIM:
        warps, smem = runtime_warps(flash_runtime_words(n1, head_dim, dm), dtype)
        return FlashGeometry(0, warps, 0, 0, smem)
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
                        float(scale), MASK_CODES[mask], int(window), geo.rows)
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
    (mma.sync m16n8k4), on FMAs in f32."""
    groups: int
    split: int
    tiles: int
    ring: int
    smem: int

    @property
    def whole(self) -> bool:
        return self.ring == 1


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
    groups = 1
    while (groups < _SCORES_MAX_GROUPS
           and bsz * -(-qtiles // (2 * groups)) >= _SCORES_BLOCKS_WANTED):
        groups *= 2
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


def scores_runtime_words(n1: int, d: int) -> int:
    """Words a K5 run-time-order warp keeps (csrc/jet_runtime.cu): its
    query's jet, the score and e-jets of 32 keys (one a lane) and the
    row's totals."""
    return n1 * d + 65 * n1


def jet_attention_scores_cuda(q: torch.Tensor, k: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """K5 on the card: q/k (n+1, B, T, D) -> the softmaxed score jet
    (n+1, B, T, T), tiled by :func:`scores_geometry` (orders past the
    templates and bfloat16: the run-time-order kernel, a warp a query)."""
    check_cuda_tensor(q, "q", 4)
    check_cuda_tensor(k, "k", 4, q.dtype)
    if k.shape != q.shape:
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    _same_device(q, k)
    n1, bsz, t, d = q.shape
    check_depth(n1)
    if runtime_path(n1, q.dtype):
        warps, smem = runtime_warps(scores_runtime_words(n1, d), q.dtype)
        check_fits("score", smem, f"head dim {d} at order {n1 - 1}")
        out = torch.empty((n1, bsz, t, t), dtype=q.dtype, device=q.device)
        cuda_lib.launch("jet_attention_scores_rt_launch", q.device, q.data_ptr(),
                        k.data_ptr(), out.data_ptr(), bsz, t, d, n1,
                        DTYPE_CODES[q.dtype], float(scale), warps)
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
