"""Contrib modules of apex_tpu_torch: ``clip_grad`` in this slice."""
