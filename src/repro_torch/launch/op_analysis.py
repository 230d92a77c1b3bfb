"""The three-term roofline of a dry-run cell, and the model's useful FLOPs.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``:
the same :class:`Roofline` (fields and ``finalize``), ``model_flops`` and
``_active_params``, with the counts from ``op_static`` (the step's local
ops) in place of the optimized HLO's, and the H100's constants in place of
the TPU's.

Constants: the NVIDIA H100 SXM5 data sheet's peaks (dense, no sparsity),
not measurements --

* 989 TFLOP/s for bfloat16 and float16 (tensor cores);
* 67 TFLOP/s for float32 and float64 (the FP32 and FP64 tensor-core rates);
* 3.35 TB/s of HBM3;
* 450 GB/s each way over NVLink 4 (900 GB/s in all) for a mesh dim whose
  every group lies within one host of ``HOST_CARDS`` cards;
* 50 GB/s for a mesh dim whose groups span hosts: one 400 Gb/s NIC per
  card.

The collective term is the bytes of each mesh dim over that dim's link;
on the production meshes every dim spans hosts (``link_bw``).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "float64": 67e12}
HBM_BW = 3.35e12          # bytes/s per card
NVLINK_BW = 450e9         # bytes/s each way, within a host
NIC_BW = 50e9             # bytes/s per card, across hosts (400 Gb/s)
HOST_CARDS = 8            # cards joined by NVLink in one host


def link_bw(sizes: Dict[str, int], dim: str) -> float:
    """Bytes/s of a collective over mesh dim ``dim`` (or dims "a+b") of a
    mesh of ``sizes`` (``{name: size}`` in the mesh's order, ranks laid out
    row-major, hosts of HOST_CARDS consecutive ranks): NVLink when each of
    its groups lies within one host -- the outermost of its dims' stride x
    size divides HOST_CARDS -- else the NIC.  An unknown dim gets the NIC."""
    names = list(sizes)
    dims = dim.split("+")
    if not all(d in sizes for d in dims):
        return NIC_BW
    outer = min(names.index(d) for d in dims)
    block = math.prod(sizes[n] for n in names[outer:])
    return NVLINK_BW if HOST_CARDS % block == 0 else NIC_BW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_gflops: float            # dot FLOPs of the rank's local ops (per card)
    hlo_gbytes: float            # memory traffic estimate (per card)
    collective_gbytes: float     # summed collective result bytes (per card)
    per_device_mem_gb: float     # arguments + peak of live temporaries, GiB
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_gflops: float = 0.0    # 6*N*D (train) / 2*N*D (inference), active
    useful_fraction: float = 0.0
    collectives: Dict[str, int] = field(default_factory=dict)
    dtype: str = "bfloat16"      # the step's dtype: picks the compute peak
    collective_dims: Dict[str, float] = field(default_factory=dict)  # GB per mesh dim
    mesh_sizes: Dict[str, int] = field(default_factory=dict)

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_gflops * 1e9 / PEAK_FLOPS[self.dtype]
        self.memory_s = self.hlo_gbytes * 1e9 / HBM_BW
        dims = self.collective_dims or {"?": self.collective_gbytes}
        self.collective_s = sum(gb * 1e9 / link_bw(self.mesh_sizes, d)
                                for d, gb in dims.items())
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        if self.hlo_gflops > 0:
            self.useful_fraction = self.model_gflops / self.hlo_gflops
        return self

    @property
    def bound_s(self) -> float:
        """The least time the step could take: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self):
        return asdict(self)


def model_flops(cfg, shape, n_chips: int) -> float:
    """Useful-model FLOPs per chip: 6*N_active*D for train, 2*N_active*D for
    inference steps (D = tokens processed per step)."""
    n_active = _active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_chips
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens / n_chips


def _active_params(cfg) -> float:
    """Parameter count engaged per token (MoE: top_k of n_experts)."""
    from repro_torch.launch.sharding import arch_param_count
    total = arch_param_count(cfg)
    if cfg.moe is None:
        return total
    # split expert weights from the rest analytically
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n_moe_layers = sum(1 for j in range(cfg.n_layers)
                       if j % cfg.moe.period == cfg.moe.period - 1)
    expert_params = n_moe_layers * e * (cfg.d_model * 2 * cfg.d_ff +
                                        cfg.d_ff * cfg.d_model)
    return (total - expert_params) + expert_params * (k / e)


def collective_bytes(totals) -> Dict[str, float]:
    """Collective result bytes for each kind, and their counts under
    "_counts": the reference's ``collective_bytes`` as a view of
    ``op_static.Totals``."""
    from repro_torch.launch.op_static import COLLECTIVE_KINDS
    out: Dict[str, float] = {k: totals.collective_bytes.get(k, 0.0) for k in COLLECTIVE_KINDS}
    out["_counts"] = {k: totals.collective_counts.get(k, 0.0)  # type: ignore[assignment]
                      for k in COLLECTIVE_KINDS}
    return out
