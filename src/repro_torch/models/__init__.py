"""The LM pool's models: the JAX package's ``models/`` (the attention
family, Mamba2, RWKV-6, MoE and the GLA engine they share)."""

from . import attention, gla, layers, moe, rwkv, ssm, transformer
from .transformer import (Knobs, decode_state_specs, decode_step, forward_seq,
                          init_model, prefill, train_loss)
