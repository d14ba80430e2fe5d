from apex_tpu_torch.transformer.layers.layer_norm import (FastLayerNorm,
                                                          FusedLayerNorm)

__all__ = ["FastLayerNorm", "FusedLayerNorm"]
