"""Hand-written CUDA kernels for the n-TangentProp hot path.

``jet_dense`` fuses one dense layer's stacked GEMM with the Faa di Bruno
activation epilogue (K1, csrc/jet_dense.cu); ``act_jet`` is the standalone
epilogue (K2, csrc/act_jet.cu); ``jet_rms_norm`` (K3, csrc/jet_rms_norm.cu)
and ``jet_flash_attention`` (K4, csrc/jet_flash_attention.cu) are the
transformer trunk's normalization and attention block;
``jet_attention_scores`` (K5, csrc/jet_attention_scores.cu) materializes
the softmaxed score jet.  Those are templated on the coefficient count up
to N1 = 9 in float32/float64; csrc/jet_runtime.cu holds the five kernels
again for any order and for bfloat16.  ``ref.py`` holds
their plain PyTorch versions; ``ops.py`` dispatches (kernel on CUDA
tensors, plain version on CPU tensors) and counts launches.  The kernels
are built at first use (cuda_lib.py), never at import.
"""

from . import ops, ref
from .ops import (EpilogueKind, act_jet, epilogues, jet_attention_scores,
                  jet_dense, jet_flash_attention, jet_rms_norm, launch_counts,
                  reset_launch_counts)

__all__ = ["ops", "ref", "EpilogueKind", "act_jet", "epilogues", "jet_dense",
           "jet_attention_scores", "jet_flash_attention", "jet_rms_norm",
           "launch_counts", "reset_launch_counts"]
