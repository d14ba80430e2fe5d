"""Fused ops: each kernel wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor."""

from apex_tpu_torch.ops.fused_ffn import fused_ffn
from apex_tpu_torch.ops.lm_head import fused_linear_cross_entropy

__all__ = ["fused_ffn", "fused_linear_cross_entropy"]
