"""Ported examples of apex_tpu (run each as ``python -m apex_tpu_torch.examples.<name>.<script>``)."""
