"""Automatic mixed precision — port of ``apex_tpu/amp`` (O0-O3, O1's
autocast and cast lists, the loss scaler, the train-loop helpers, and the
legacy pre-``initialize`` surface of ``amp/legacy.py``: ``init``, the
casting decorators and the function registry)."""
from apex_tpu_torch.amp.frontend import AmpState, Properties, initialize
from apex_tpu_torch.amp.handle import scale_loss, unscale_step
from apex_tpu_torch.amp.interpreter import autocast
from apex_tpu_torch.amp.lists import BLACKLIST, PROMOTE, WHITELIST
from apex_tpu_torch.amp.scaler import LossScaler
# legacy pre-initialize surface (apex amp.py / opt.py / rnn_compat.py)
from apex_tpu_torch.amp.legacy import (float_function, half_function, init,
                                       promote_function,
                                       register_float_function,
                                       register_half_function,
                                       register_promote_function)


def master_params(optimizer):
    """The f32 master values held by a fused optimizer (apex
    ``amp.master_params(optimizer)``)."""
    return optimizer.master_params()


__all__ = ["AmpState", "Properties", "initialize", "scale_loss",
           "unscale_step", "master_params", "autocast", "LossScaler",
           "WHITELIST", "BLACKLIST", "PROMOTE",
           # legacy surface
           "init", "half_function", "float_function", "promote_function",
           "register_half_function", "register_float_function",
           "register_promote_function"]
