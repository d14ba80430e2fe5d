"""Fused ops: each kernel wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor."""
