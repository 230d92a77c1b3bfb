"""Runtime: the fault-tolerant trainer and the latency statistics the
serving layer keeps."""

from .metrics import LatencyStats, percentile
from .trainer import Trainer, TrainerConfig, TrainerReport

__all__ = ["LatencyStats", "Trainer", "TrainerConfig", "TrainerReport", "percentile"]
