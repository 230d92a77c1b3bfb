"""Data parallelism over ``torch.distributed``: the sharded jet engine, the
data-parallel train step, and gradient compression with error feedback."""

from .compression import (compressed_psum_tree, dequantize_int8, ef_compress,
                          ef_init, quantize_int8, sum_over_ranks, topk_mask,
                          topk_psum_tree)
from .jet_shard import (DATA_AXIS, DataMesh, ShardedEngine, ShardedTrainStep,
                        build_sharded_train_step, gather_rows, pad_rows,
                        resolve_mesh)

__all__ = [
    "DATA_AXIS", "DataMesh", "ShardedEngine", "ShardedTrainStep",
    "build_sharded_train_step", "compressed_psum_tree", "dequantize_int8",
    "ef_compress", "ef_init", "gather_rows", "pad_rows", "quantize_int8",
    "resolve_mesh", "sum_over_ranks", "topk_mask", "topk_psum_tree",
]
