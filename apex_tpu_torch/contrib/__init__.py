"""Contrib modules of apex_tpu_torch: ``clip_grad``, ``xentropy`` and
``optimizers`` (the apex contrib import paths of the fused and ZeRO
optimizers)."""
