"""Device resolution — the port's counterpart of
``apex_tpu/utils/platform.py``.

The JAX package picks Pallas or jnp at run time from the backend.  The port
has no such switch: entry points run on the card unless the caller asks for
another device, and each kernel wrapper dispatches on the device of the
tensor it is given (a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel or raises).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when None.

    Raises when CUDA is wanted but this PyTorch has no usable card: the
    port never falls back to the CPU on its own.  Pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
