"""O1 per-op cast lists — port of ``apex_tpu/amp/lists.py`` (apex
``amp/lists/*.py``).

The JAX package classifies the primitives of a traced jaxpr; the port
classifies the torch functions a model calls, by name (``func.__name__``:
``torch.add``, ``Tensor.add`` and ``Tensor.__add__`` are all additions),
each JAX primitive class mapped onto its torch ops:

* WHITELIST (``dot_general``, ``conv_general_dilated``): convolutions and
  matrix products run in the low-precision compute dtype;
* BLACKLIST (``exp``, ``log``, ``pow``, ``rsqrt``, ``reduce_sum``,
  ``logistic`` ...): their torch ops, the reductions built on them
  (``sum``, ``mean``, ``prod``, ``var``, norms, ``logsumexp``), and apex's
  FP32 functions built from them (softmax, log_softmax, the
  normalisations, the losses) run in f32;
* PROMOTE (``add``, ``sub``, ``mul``, ``div``, ``max``, ``min``,
  ``concatenate``, ``select_n``, ``clamp``, the comparisons): multi-argument
  element-wise ops take the widest floating dtype among their tensors.

Everything else runs in the dtypes it is given.  These lists differ from
``torch.autocast``'s (which keeps ``batch_norm`` and the element-wise ops
in half precision), so the port applies its own
(:func:`apex_tpu_torch.amp.interpreter.autocast`).
"""

from __future__ import annotations

__all__ = ["WHITELIST", "BLACKLIST", "PROMOTE", "classify"]

# MXU / tensor-core ops: inputs cast to the compute dtype
WHITELIST = {
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "linear", "bilinear", "matmul", "__matmul__",
    "__rmatmul__", "mm", "bmm", "mv", "addmm", "addbmm", "baddbmm", "addmv",
    "einsum", "dot", "vdot", "inner", "tensordot",
}

# precision-sensitive ops: inputs cast to f32
BLACKLIST = {
    # element-wise transcendental functions
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "pow",
    "__pow__", "__rpow__", "float_power", "square", "sigmoid", "logsigmoid",
    "erf", "erfc", "erfinv", "rsqrt", "lgamma", "digamma", "acos",
    "arccos", "asin", "arcsin", "atan", "arctan", "atan2", "arctan2",
    "cosh", "sinh", "asinh", "arcsinh", "acosh", "arccosh", "atanh",
    "arctanh",
    # reductions (reduce_sum, reduce_prod, cumsum, cumprod, cumlogsumexp)
    "sum", "nansum", "mean", "nanmean", "prod", "cumsum", "cumprod",
    "logcumsumexp", "logsumexp", "var", "std", "var_mean", "std_mean",
    "norm", "renorm", "dist", "cdist",
    # apex's FP32 functions built on them
    "softmax", "log_softmax", "softmin", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "local_response_norm", "rms_norm",
    "normalize", "cross_entropy", "nll_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "mse_loss", "l1_loss",
    "smooth_l1_loss", "huber_loss", "poisson_nll_loss",
    "cosine_similarity", "softplus",
}

# multi-argument element-wise ops: the widest floating dtype wins
PROMOTE = {
    "add", "__add__", "__radd__", "sub", "subtract", "__sub__", "__rsub__",
    "rsub", "mul", "multiply", "__mul__", "__rmul__", "div", "divide",
    "true_divide", "__truediv__", "__rtruediv__", "maximum", "minimum",
    "max", "min", "fmax", "fmin", "remainder", "fmod", "__mod__",
    "nextafter", "cat", "concat", "concatenate", "stack", "hstack",
    "vstack", "where", "clamp", "clip", "addcmul", "addcdiv", "lerp",
    "eq", "ne", "lt", "le", "gt", "ge", "__eq__", "__ne__", "__lt__",
    "__le__", "__gt__", "__ge__",
}


def classify(func) -> str:
    """``"whitelist"``, ``"blacklist"``, ``"promote"`` or
    ``"passthrough"`` for a torch function or ``Tensor`` method."""
    name = getattr(func, "__name__", "")
    if name in WHITELIST:
        return "whitelist"
    if name in BLACKLIST:
        return "blacklist"
    if name in PROMOTE:
        return "promote"
    return "passthrough"
