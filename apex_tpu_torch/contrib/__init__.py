"""apex.contrib counterparts — port of ``apex_tpu/contrib/__init__.py``.

The reference's lazy table lists every contrib subpackage; this one lists
those the port has, imported on first attribute access (``contrib.fmha``)
or directly (``apex_tpu_torch.contrib.fmha``).  Still to port:
``sparsity``, ``gpu_direct_storage``, ``bottleneck``, ``peer_memory``,
``nccl_p2p`` and ``nccl_allocator``.
"""

import importlib as _importlib

_SUBMODULES = (
    "clip_grad",
    "xentropy",
    "focal_loss",
    "group_norm",
    "groupbn",
    "index_mul_2d",
    "multihead_attn",
    "fmha",
    "layer_norm",
    "optimizers",
    "transducer",
    "conv_bias_relu",
    "cudnn_gbn",
    "openfold_triton",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return _importlib.import_module(f"apex_tpu_torch.contrib.{name}")
    raise AttributeError(f"module 'apex_tpu_torch.contrib' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
