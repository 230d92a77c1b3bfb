"""Runtime: the fault-tolerant trainer, the GPipe schedule and the latency
statistics the serving layer keeps."""

from .metrics import LatencyStats, percentile
from .pipeline import gpipe, pipeline_bubble_fraction
from .trainer import Trainer, TrainerConfig, TrainerReport

__all__ = ["LatencyStats", "Trainer", "TrainerConfig", "TrainerReport", "gpipe",
           "percentile", "pipeline_bubble_fraction"]
