"""Config registry: ``get_arch(name)`` / ``--arch <id>`` over the ten LM
architectures and the two PINN ones."""

from __future__ import annotations

from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ArchConfig, EncoderCfg, MoECfg, ShapeCfg, shape_applicable)


def _load_all():
    from . import (gemma2_27b, gemma3_4b, granite_3_2b, llama4_maverick,
                   llava_next_mistral_7b, mixtral_8x7b, pinn_mlp, pinn_pde,
                   qwen3_0_6b, rwkv6_3b, whisper_large_v3, zamba2_2_7b)
    mods = [gemma3_4b, qwen3_0_6b, gemma2_27b, granite_3_2b, mixtral_8x7b,
            llama4_maverick, zamba2_2_7b, whisper_large_v3,
            llava_next_mistral_7b, rwkv6_3b, pinn_mlp, pinn_pde]
    return {m.CONFIG.name: m.CONFIG for m in mods}


_REGISTRY = None


def registry() -> dict[str, ArchConfig]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load_all()
    return _REGISTRY


def get_arch(name: str) -> ArchConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
    return reg[name]


ASSIGNED = (
    "gemma3-4b", "qwen3-0.6b", "gemma2-27b", "granite-3-2b", "mixtral-8x7b",
    "llama4-maverick-400b-a17b", "zamba2-2.7b", "whisper-large-v3",
    "llava-next-mistral-7b", "rwkv6-3b",
)
