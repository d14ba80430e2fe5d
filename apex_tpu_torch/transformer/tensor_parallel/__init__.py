from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear_with_grad_accumulation_and_async_allreduce,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
    gather_from_sequence_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    column_parallel_linear_overlap,
    row_parallel_linear_overlap,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint,
    get_cuda_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_rng_key,
    CudaRNGStatesTracker,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    divide,
    split_tensor_along_last_dim,
    split_tensor_into_1d_equal_chunks,
    gather_split_1d_tensor,
    VocabUtility,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "linear_with_grad_accumulation_and_async_allreduce",
    "vocab_parallel_cross_entropy",
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "column_parallel_linear_overlap",
    "row_parallel_linear_overlap",
    "checkpoint",
    "get_cuda_rng_tracker",
    "model_parallel_cuda_manual_seed",
    "model_parallel_rng_key",
    "CudaRNGStatesTracker",
    "divide",
    "split_tensor_along_last_dim",
    "split_tensor_into_1d_equal_chunks",
    "gather_split_1d_tensor",
    "VocabUtility",
    "broadcast_data",
]
