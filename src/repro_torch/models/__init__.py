"""The LM pool's models: the JAX package's ``models/`` (the attention
family, Mamba2, RWKV-6, MoE and the GLA engine they share) and the
logical-axis sharding rules they annotate with."""

from . import attention, gla, layers, moe, rwkv, sharding_rules, ssm, transformer
from .transformer import (Knobs, decode_state_specs, decode_step, forward_seq,
                          init_model, param_specs, prefill, train_loss)
