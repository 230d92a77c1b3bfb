"""The LM pool's models: the attention family (dense, VLM stub,
encoder-decoder) of the JAX package's ``models/``."""

from . import attention, layers, transformer
from .transformer import (Knobs, decode_state_specs, decode_step, forward_seq,
                          init_model, prefill, train_loss)
