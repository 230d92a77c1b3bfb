"""Architecture / shape configuration system.

``ArchConfig`` is the single composable description every model of the
port consumes (``repro_torch.models`` for the LM pool, the PINN trainers for
``pinn-mlp`` / ``pinn-pde``); each architecture instantiates one in its own
configs/<id>.py with the exact public-literature hyperparameters, plus a
``reduced()`` variant for CPU smoke tests.  Field for field the JAX
package's record, so a config means the same thing to both packages.

Shapes are the assignment's four input regimes.  ``kind`` decides which step
is lowered: ``train`` -> train_step, ``prefill`` -> prefill forward,
``decode`` -> serve_step (1 new token against a seq_len-deep cache).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# model-parallel axis size on both assigned meshes (16x16 and 2x16x16);
# spec-selection helpers use it to pick shardable dims (heads vs head_dim).
MODEL_AXIS = 16


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    period: int = 1  # every `period`-th layer is MoE (llama4 interleaves dense/MoE)


@dataclass(frozen=True)
class EncoderCfg:
    """Encoder stack for enc-dec models (whisper); frontend is a stub that
    provides precomputed frame embeddings per the assignment."""

    n_layers: int
    seq: int = 1500  # whisper: 30 s of audio at 50 fps after the conv stub


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # block pattern: cycled over layers, e.g. ("local",)*5 + ("global",)
    attn_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096               # sliding-window size for "local" layers
    mlp: str = "swiglu"              # swiglu | geglu | gelu_mlp
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    # moe
    moe: Optional[MoECfg] = None
    # ssm / hybrid
    block_type: str = "attn"         # attn | mamba2 | rwkv6
    ssm_state: int = 64
    ssm_heads: int = 0               # 0 -> d_inner // 64
    hybrid_shared_attn_every: int = 0  # zamba2: shared attn block period
    # enc-dec / vlm stubs
    encoder: Optional[EncoderCfg] = None
    vlm_image_tokens: int = 0        # llava anyres stub: patch embeds fused at front
    # numerics / layout
    dtype: str = "bfloat16"
    scan_group: int = 0              # layers per scan body; 0 -> len(attn_pattern)
    remat: bool = True               # activation checkpointing across layer groups
    attn_sharding: str = "auto"      # auto | replicate (perf knob; see section Perf)
    source: str = ""                 # [citation; verification tier]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group(self) -> int:
        """Layers per scan body; layers beyond the last full group are
        unrolled as a remainder (gemma3: 34 = 5 groups of 6 + 4 rest)."""
        return self.scan_group or len(self.attn_pattern)

    def reduced(self, **overrides) -> "ArchConfig":
        """CPU-smoke-test scale: same family/topology, tiny dims."""
        pat = self.attn_pattern
        small = dict(
            n_layers=2 * len(pat) if self.hybrid_shared_attn_every == 0 else 4,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            window=16,
            moe=MoECfg(4, self.moe.top_k, self.moe.capacity_factor) if self.moe else None,
            ssm_state=16,
            ssm_heads=2,
            hybrid_shared_attn_every=2 if self.hybrid_shared_attn_every else 0,
            encoder=EncoderCfg(n_layers=2, seq=32) if self.encoder else None,
            vlm_image_tokens=8 if self.vlm_image_tokens else 0,
            dtype="float32",
            remat=False,
            scan_group=2 if self.hybrid_shared_attn_every else 0,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeCfg("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCfg("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCfg("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCfg("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# archs whose every layer is full global attention: long_500k skipped
PURE_FULL_ATTENTION = frozenset({"qwen3-0.6b", "granite-3-2b", "whisper-large-v3"})


def shape_applicable(arch: ArchConfig, shape: ShapeCfg) -> bool:
    if shape.name == "long_500k" and arch.name in PURE_FULL_ATTENTION:
        return False
    return True
