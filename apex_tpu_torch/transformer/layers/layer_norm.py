"""Port of ``apex_tpu/transformer/layers/layer_norm.py`` (apex
``transformer/layers/layer_norm.py``).

apex picks ``FastLayerNorm`` (a persistent kernel for fixed hidden sizes)
or ``MixedFusedLayerNorm``, and tags the norm with
``sequence_parallel_enabled`` for the gradient sync of the
sequence-parallel region.  Here both names are
:class:`~apex_tpu_torch.normalization.MixedFusedLayerNorm`, on the
LayerNorm forward and backward kernels (#1, #2) for every hidden size; the
tag is kept on the module.
"""

from __future__ import annotations

from apex_tpu_torch.normalization.fused_layer_norm import MixedFusedLayerNorm

__all__ = ["FastLayerNorm", "FusedLayerNorm"]


class FusedLayerNorm(MixedFusedLayerNorm):
    def __init__(self, hidden_size, eps=1e-5,
                 sequence_parallel_enabled: bool = False, **kwargs):
        super().__init__(hidden_size, eps=eps, **kwargs)
        self.sequence_parallel_enabled = bool(sequence_parallel_enabled)


class FastLayerNorm(FusedLayerNorm):
    """apex's fixed-size persistent kernel; the kernels here take every
    size, so this is the same module."""
