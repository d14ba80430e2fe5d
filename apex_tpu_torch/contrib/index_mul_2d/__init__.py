"""index_mul_2d — port of ``apex_tpu/contrib/index_mul_2d/__init__.py``:
``out = in1[idx] * in2``, whose backward scatter-adds into ``in1``'s rows
(autograd's ``index_select`` backward)."""

from __future__ import annotations

import torch

__all__ = ["index_mul_2d"]


def index_mul_2d(in1, in2, idx):
    """``in1[idx] * in2`` where ``in1`` is ``(N, D)``, ``idx`` ``(M,)``
    int rows, ``in2`` ``(M, D)``; returns ``(M, D)``."""
    if in1.dim() != 2 or in2.dim() != 2:
        raise ValueError("index_mul_2d operates on 2-D operands")
    return torch.index_select(in1, 0, idx.to(in1.device, torch.int64)) * in2
