"""Automatic mixed precision — port of ``apex_tpu/amp`` (O0-O3, O1's
autocast and cast lists, the loss scaler and the train-loop helpers).  The
legacy pre-``initialize`` surface (``amp/legacy.py``) is not ported yet."""
from apex_tpu_torch.amp.frontend import AmpState, Properties, initialize
from apex_tpu_torch.amp.handle import scale_loss, unscale_step
from apex_tpu_torch.amp.interpreter import autocast
from apex_tpu_torch.amp.lists import BLACKLIST, PROMOTE, WHITELIST
from apex_tpu_torch.amp.scaler import LossScaler


def master_params(optimizer):
    """The f32 master values held by a fused optimizer (apex
    ``amp.master_params(optimizer)``)."""
    return optimizer.master_params()


__all__ = ["AmpState", "Properties", "initialize", "scale_loss",
           "unscale_step", "master_params", "autocast", "LossScaler",
           "WHITELIST", "BLACKLIST", "PROMOTE"]
