from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm", "fused_layer_norm_affine", "fused_layer_norm",
           "fused_rms_norm_affine", "fused_rms_norm"]
