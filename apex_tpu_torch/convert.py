"""Carry weights and optimizer state from the JAX package into the port.

:func:`gpt_params_from_jax` takes the parameter tree of
``apex_tpu.models.gpt.GPTModel.init_params`` with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``; this module never
imports JAX) and returns a state dict for
:class:`apex_tpu_torch.models.gpt.GPTModel`.  The port's parameter names
are the tree's paths joined by dots, so the mapping is a flatten; shapes
are checked against the model the config describes.

Under tensor parallelism both take ``rank=r``: the serial tree converted,
then cut into rank ``r``'s shards (``models.gpt.shard_params_for_tp``,
the JAX ``shard_params_for_tp`` slicing; BERT by its partition specs), for
the model of the tensor-parallel ``cfg``.  The GPT conversion also cuts an
expert-parallel rank's experts (``expert_rank=``) and a pipeline rank's
layers (``pipeline_stage=``): the per-rank counterparts of the JAX
package's ``pack_for_shard_map``.

:func:`gpt_quant_params_from_jax` carries a tree that the JAX
``quantize_decode_params`` quantized: int8 weights and their f32 scales
bit for bit, for a model with ``weight_quant="int8"``.

:func:`bert_params_from_jax` does the same for
:class:`apex_tpu_torch.models.bert.BertModel`, and
:func:`mlp_params_from_jax` / :func:`fused_dense_params_from_jax` for the
modules of :mod:`apex_tpu_torch.mlp` and :mod:`apex_tpu_torch.fused_dense`
(their parameter names are the JAX dicts' keys).  The fused FFN reads the
models' ``fc1`` / ``fc2`` leaves, so ``fused_ffn`` changes no conversion.

:func:`resnet_params_from_jax` takes the ``(params, state)`` trees of
``apex_tpu.models.resnet.ResNet`` and returns a state dict for
:class:`apex_tpu_torch.models.resnet.ResNet`: HWIO convolution weights
become OIHW, the head's ``(features, classes)`` weight becomes ``(classes,
features)``, and each ``BatchNormState`` fills its unit's buffers.

:func:`fused_adam_state_from_jax`, :func:`fused_lamb_state_from_jax`,
:func:`fused_sgd_state_from_jax`, :func:`fused_adagrad_state_from_jax` and
:func:`fused_novograd_state_from_jax` carry the per-leaf state of the JAX
optimizers (``bucketed=False``) over to the port's: the moments and,
under master weights, the f32 masters.  Each takes the model's leaf layout
(``layout=resnet_layout`` for a ResNet; the transformers keep the JAX
layout).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apex_tpu_torch.models import bert as _bert
from apex_tpu_torch.models import gpt as _gpt
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                       quantize_decode_params)
from apex_tpu_torch.models.resnet import ResNet, ResNetConfig

__all__ = ["gpt_params_from_jax", "gpt_quant_params_from_jax",
           "bert_params_from_jax",
           "mlp_params_from_jax", "fused_dense_params_from_jax",
           "resnet_params_from_jax", "resnet_layout",
           "fused_adam_state_from_jax",
           "fused_lamb_state_from_jax", "fused_sgd_state_from_jax",
           "fused_adagrad_state_from_jax", "fused_novograd_state_from_jax"]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}{key}.")


def _params_from_jax(tree, model) -> dict:
    """State dict of ``model`` (a model on the ``meta`` device) from a JAX
    parameter tree: each leaf as a CPU tensor in the dtype of the port
    parameter it fills (a bf16 leaf goes through f32, which holds it
    exactly)."""
    expected = {name: p for name, p in model.state_dict().items()}
    sd = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if name not in expected:
            raise KeyError(f"JAX parameter {name!r} has no counterpart in "
                           f"apex_tpu_torch's {type(model).__name__}")
        want = expected[name]
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{tuple(want.shape)}")
        sd[name] = torch.from_numpy(arr.copy()).to(want.dtype)
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"JAX tree lacks {missing}")
    return sd


def _serial(cfg):
    extra = {}
    if isinstance(cfg, GPTConfig):
        extra = dict(expert_parallel_size=1, expert_axis=None)
    return dataclasses.replace(cfg, tensor_parallel_size=1, axis_name=None,
                               sequence_parallel=False, overlap_chunks=0,
                               plan=None, **extra)


def _rank_params(tree, cfg, rank, model_cls, shard):
    """The serial conversion, then rank ``rank``'s shards of it, checked
    against the tensor-parallel model's shapes."""
    t = cfg.tensor_parallel_size
    if rank is None:
        if t > 1:
            raise ValueError(f"tensor_parallel_size={t}: pass the rank whose "
                             "shards to return")
        return _params_from_jax(tree, model_cls(cfg, device="meta"))
    if not 0 <= int(rank) < t:
        raise ValueError(f"rank {rank} is not in [0, {t})")
    sd = shard(cfg, _params_from_jax(
        tree, model_cls(_serial(cfg), device="meta")), int(rank))
    for name, want in model_cls(cfg, device="meta").state_dict().items():
        if tuple(sd[name].shape) != tuple(want.shape):
            raise ValueError(f"{name}: shard {tuple(sd[name].shape)} != "
                             f"port shape {tuple(want.shape)}")
    return sd


def gpt_params_from_jax(tree, cfg: GPTConfig, rank=None, *,
                        expert_rank=None, pipeline_stage=None) -> dict:
    """State dict (CPU tensors in ``cfg.param_dtype``) for
    ``GPTModel(cfg)`` from a JAX GPT parameter tree of numpy arrays (the
    serial tree).  Load it with ``model.load_state_dict(sd)``.  Raises when
    the tree's names or shapes do not match the model.

    A MoE slot's ``gate`` / ``w1`` / ``w2`` carry over whole.  Of a
    parallel ``cfg`` it returns one rank's part: with ``rank``, that
    tensor-parallel rank's shards (a MoE slot's expert stacks cut along
    their FFN dimension); with ``expert_rank``, that expert-parallel rank's
    ``n_experts / expert_parallel_size`` experts
    (:func:`~apex_tpu_torch.transformer.expert_parallel.
    localize_expert_params`); with ``pipeline_stage=(n_stages, n_virtual,
    stage)``, that pipeline rank's layers in its chunk order
    (:func:`~apex_tpu_torch.models.gpt.stage_state_dict`, for
    ``GPTModel(cfg, pipeline_stage=...)``).  A context-parallel rank holds
    the whole model (its parameters are replicated over the group): the
    serial conversion is its state dict."""
    from apex_tpu_torch.transformer.expert_parallel import (
        localize_expert_params)
    t, ep = cfg.tensor_parallel_size, cfg.expert_parallel_size
    if t == 1 and ep == 1 and pipeline_stage is None:
        return _rank_params(tree, cfg, rank, GPTModel,
                            _gpt.shard_params_for_tp)
    sd = _params_from_jax(tree, GPTModel(_serial(cfg), device="meta"))
    if t > 1:
        if rank is None or not 0 <= int(rank) < t:
            raise ValueError(f"tensor_parallel_size={t}: pass the rank "
                             f"(in [0, {t})) whose shards to return")
        sd = _gpt.shard_params_for_tp(cfg, sd, int(rank))
    if ep > 1:
        if expert_rank is None:
            raise ValueError(f"expert_parallel_size={ep}: pass the "
                             "expert_rank whose experts to return")
        sd = localize_expert_params(sd, int(expert_rank), ep)
    if pipeline_stage is not None:
        sd = _gpt.stage_state_dict(sd, cfg.num_layers, *pipeline_stage)
    want = GPTModel(cfg, device="meta",
                    pipeline_stage=pipeline_stage).state_dict()
    if set(sd) != set(want):
        raise KeyError(f"the converted names differ from the model's: "
                       f"{sorted(set(sd) ^ set(want))[:8]}")
    for name, w in want.items():
        if tuple(sd[name].shape) != tuple(w.shape):
            raise ValueError(f"{name}: shard {tuple(sd[name].shape)} != "
                             f"port shape {tuple(w.shape)}")
    return sd


def gpt_quant_params_from_jax(tree, cfg: GPTConfig) -> dict:
    """State dict for a ``GPTModel(cfg)`` with ``cfg.weight_quant ==
    "int8"`` from a JAX tree that ``apex_tpu.models.gpt.
    quantize_decode_params`` quantized (numpy leaves): the int8 weights and
    their f32 ``weight_scale`` rows are carried bit for bit, every other
    leaf as :func:`gpt_params_from_jax` carries it.  Install it with
    :meth:`GPTModel.load_quantized_`.  Raises when a name, shape or the
    dtype of a quantized leaf does not match."""
    if cfg.weight_quant != "int8":
        raise ValueError("gpt_quant_params_from_jax needs "
                         "GPTConfig(weight_quant='int8')")
    expected = quantize_decode_params(GPTModel(cfg, device="meta")
                                      .state_dict())
    sd = {}
    for name, leaf in _flatten(tree):
        if name not in expected:
            raise KeyError(f"JAX parameter {name!r} has no counterpart in "
                           "apex_tpu_torch's quantized GPTModel")
        want = expected[name]
        arr = np.asarray(leaf)
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{tuple(want.shape)}")
        if name.endswith(".weight_scale") or want.dtype == torch.int8:
            exact = np.int8 if want.dtype == torch.int8 else np.float32
            if arr.dtype != exact:
                raise ValueError(f"{name}: JAX dtype {arr.dtype}, want "
                                 f"{np.dtype(exact)}")
            sd[name] = torch.from_numpy(arr.copy())
        else:
            sd[name] = torch.from_numpy(
                np.asarray(arr, np.float32).copy()).to(want.dtype)
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"JAX tree lacks {missing}")
    return sd


def bert_params_from_jax(tree, cfg: BertConfig, rank=None) -> dict:
    """State dict for ``BertModel(cfg)`` from a JAX BERT parameter tree of
    numpy arrays: each leaf in the dtype of the port parameter it fills
    (``cfg.param_dtype``, f32 for the LayerNorms), so an O2-cast tree
    (bf16 leaves) carries over exactly; ``load_state_dict`` then rounds
    nothing into a model cast by ``amp.initialize``.  With ``rank``, that
    rank's shards for a tensor-parallel ``cfg``.  Raises when the tree's
    names or shapes do not match the model."""
    return _rank_params(tree, cfg, rank, BertModel,
                        _bert.shard_params_for_tp)


def mlp_params_from_jax(tree, module) -> dict:
    """State dict for ``module`` (an :class:`apex_tpu_torch.mlp.MLP` of the
    JAX ``MLP``'s sizes and bias) from the JAX ``init_params`` dict of
    numpy arrays (``{"weights": [...], "biases": [...]}``)."""
    return _params_from_jax(tree, module)


def fused_dense_params_from_jax(tree, module) -> dict:
    """State dict for ``module`` (a :class:`~apex_tpu_torch.fused_dense.
    FusedDense` or ``FusedDenseGeluDense``) from the JAX module's
    ``init_params`` dict of numpy arrays."""
    return _params_from_jax(tree, module)


def resnet_layout(name, arr):
    """A ResNet leaf in the port's layout: HWIO convolution weights to
    OIHW, the head weight ``(features, classes)`` to ``(classes,
    features)``; anything else as it is."""
    if name == "head.weight":
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def resnet_params_from_jax(params, state, cfg: ResNetConfig) -> dict:
    """State dict (CPU tensors) for ``ResNet(cfg)`` from the JAX ResNet's
    ``params`` and ``state`` trees with numpy leaves: the parameters in the
    port's layout and each ``BatchNormState`` (``running_mean``,
    ``running_var``, ``num_batches_tracked``) in its unit's buffers.  Load
    it with ``model.load_state_dict(sd)``.  Raises when names or shapes do
    not match the model."""
    tree = {name: resnet_layout(name, np.asarray(leaf, np.float32))
            for name, leaf in _flatten(params)}
    fields = ("running_mean", "running_var", "num_batches_tracked")

    def units(prefix, st):
        if isinstance(st, tuple) and len(st) == 3 and not isinstance(
                st[0], (dict, list, tuple)):
            for field, leaf in zip(fields, st):
                tree[f"{prefix}{field}"] = np.asarray(leaf)
            return
        items = st.items() if isinstance(st, dict) else enumerate(st)
        for key, sub in items:
            units(f"{prefix}{key}.", sub)

    units("", state)
    model = ResNet(cfg, device="meta")
    expected = model.state_dict()
    if set(tree) != set(expected):
        raise KeyError(f"JAX ResNet trees and the port's ResNet differ: "
                       f"{sorted(set(tree) ^ set(expected))}")
    sd = {}
    for name, arr in tree.items():
        want = expected[name]
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} (port layout) "
                             f"!= port shape {tuple(want.shape)}")
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(want.dtype)
    return sd


def _jax_leaf_order(names):
    """``names`` (dotted parameter paths) in the order ``jax.tree_util``
    flattens the nested tree they spell: dict keys sorted, list items
    (numeric components) by index."""
    def key(name):
        return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                     for c in name.split("."))
    return sorted(names, key=key)


_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                      torch.float16: "float16"}


def _same_layout(name, arr):
    return arr


def _per_leaf_state_from_jax(state, model, keys, layout) -> dict:
    """The per-leaf state of a JAX ``bucketed=False`` optimizer over
    ``model``'s parameter tree, keyed by ``model.named_parameters()`` names.

    ``state``: ``{"step": int, "buckets": {"<group>/<dtype>": {key:
    [...]}}}`` with numpy leaves.  There is one bucket per (group, dtype):
    a bucket's lists follow the tree's leaves of its dtype in flatten order
    (JAX ``base.py:165-181``), so the model's parameters must carry the
    dtypes of the JAX tree the state was made for (cast the model as the
    tree was).  ``keys`` maps JAX state keys to port state keys; a key a
    bucket lacks (``master`` for an f32 bucket) is left out.  ``layout``
    puts a leaf in the port's layout (None: the JAX layout).
    """
    params = dict(model.named_parameters())
    layout = layout or _same_layout
    by_dtype = {}
    for name in _jax_leaf_order(params):
        by_dtype.setdefault(_TORCH_DTYPE_NAMES[params[name].dtype],
                            []).append(name)
    groups = {key.split("/")[0] for key in state["buckets"]}
    if len(groups) != 1:
        raise ValueError(f"expected the buckets of one parameter group, got "
                         f"{list(state['buckets'])}")
    out = {name: {} for name in params}
    for key, bucket in state["buckets"].items():
        dtype = key.split("/")[1]
        names = by_dtype.get(dtype, [])
        for jkey, tkey in keys.items():
            if jkey not in bucket:
                continue
            leaves = bucket[jkey]
            if len(leaves) != len(names):
                raise ValueError(f"bucket {key}: the JAX state has "
                                 f"{len(leaves)} leaves, the model "
                                 f"{len(names)} {dtype} parameters")
            for name, leaf in zip(names, leaves):
                p = params[name]
                arr = np.asarray(leaf, np.float32)
                if arr.ndim:
                    arr = np.ascontiguousarray(layout(name, arr))
                if arr.ndim and arr.shape != tuple(p.shape):
                    raise ValueError(f"{name}: JAX {jkey} shape {arr.shape} "
                                     f"!= parameter shape {tuple(p.shape)}")
                out[name][tkey] = torch.from_numpy(arr.copy()).to(p.device)
    return {"step": int(np.asarray(state["step"])), "state": out}


def fused_adam_state_from_jax(state, model, layout=None) -> dict:
    """The JAX per-leaf ``FusedAdam`` state of ``model``'s parameter tree,
    for the port's :class:`~apex_tpu_torch.optimizers.FusedAdam`.

    ``state``: ``{"step": int, "buckets": {"<group>/<dtype>": {"m": [...],
    "v": [...]}}}`` with numpy leaves (``jax.tree_util.tree_map(np.asarray,
    opt_state)``) of a ``bucketed=False`` optimizer over one parameter
    group.  Returns ``{"step": int, "state": {name: {"exp_avg": tensor,
    "exp_avg_sq": tensor}}}`` keyed by ``model.named_parameters()`` names,
    on the parameters' devices: copy ``state[name]`` into
    ``optimizer.state[param]`` and ``step`` into the group's ``"step"``.
    ``layout(name, array)`` puts a leaf in the port's layout where the
    model's differs from the JAX tree's (:func:`resnet_layout` for a
    ResNet); None keeps it.
    """
    return _per_leaf_state_from_jax(state, model, {"m": "exp_avg",
                                                   "v": "exp_avg_sq"},
                                    layout)


def fused_lamb_state_from_jax(state, model, layout=None) -> dict:
    """The JAX per-leaf ``FusedLAMB`` state of ``model``'s parameter tree,
    for the port's :class:`~apex_tpu_torch.optimizers.FusedLAMB`: as
    :func:`fused_adam_state_from_jax`, plus ``"master"`` (f32) for every
    parameter of a bucket that keeps masters (the non-f32 buckets under
    master weights, e.g. amp O2's bf16 leaves)."""
    return _per_leaf_state_from_jax(state, model, {
        "m": "exp_avg", "v": "exp_avg_sq", "master": "master"}, layout)


def fused_sgd_state_from_jax(state, model, layout=None) -> dict:
    """The JAX per-leaf ``FusedSGD`` state of ``model``'s parameter tree,
    for the port's :class:`~apex_tpu_torch.optimizers.FusedSGD`: as
    :func:`fused_adam_state_from_jax`, with ``"momentum_buffer"`` (and
    ``"master"`` under master weights)."""
    return _per_leaf_state_from_jax(state, model, {
        "momentum_buffer": "momentum_buffer", "master": "master"}, layout)


def fused_adagrad_state_from_jax(state, model, layout=None) -> dict:
    """The JAX per-leaf ``FusedAdagrad`` state, for the port's
    :class:`~apex_tpu_torch.optimizers.FusedAdagrad`: ``"sum"`` (and
    ``"master"`` under master weights)."""
    return _per_leaf_state_from_jax(state, model, {"sum": "sum",
                                                   "master": "master"},
                                    layout)


def fused_novograd_state_from_jax(state, model, layout=None) -> dict:
    """The JAX per-leaf ``FusedNovoGrad`` state, for the port's
    :class:`~apex_tpu_torch.optimizers.FusedNovoGrad`: ``"exp_avg"`` (the
    JAX ``m``), ``"exp_avg_sq"`` (``v``, one 0-dim f32 tensor per
    parameter) and ``"master"`` under master weights."""
    return _per_leaf_state_from_jax(state, model, {
        "m": "exp_avg", "v": "exp_avg_sq", "master": "master"}, layout)


def distributed_state_from_jax(opt, state) -> dict:
    """A JAX ZeRO optimizer's state (``DistributedFusedAdam`` /
    ``DistributedFusedLAMB``) as this rank's ``opt.state_dict()``.

    ``state``: ``{"step": int, "buckets": {key: {"m", "v"[, "master"]}}}``
    with numpy leaves, each bucket the global ``(nrows, 128)`` array that
    ``shard_map`` reassembles from the per-device shards (out_specs
    ``state_specs()``).  The port's buckets carry the JAX keys
    (``"default/float32"``, with ``"/j"`` under ``message_size``) when its
    parameters are one group in the JAX tree's leaf order with the same
    ``block_rows`` and world size; each bucket's rows must agree.  Rank
    ``r`` takes rows ``[r L, (r+1) L)``.  Pass the result to
    ``opt.load_state_dict``.
    """
    sd = opt.state_dict()
    device = opt.param_groups[0]["params"][0].device
    for info in opt._layout().buckets:
        if info.key not in state["buckets"]:
            raise ValueError(f"the JAX state has no bucket {info.key!r} "
                             f"(it has {sorted(state['buckets'])})")
        rows = opt._local_rows(info)
        lo = opt.rank * rows
        shards = {}
        for name, arr in state["buckets"][info.key].items():
            arr = np.asarray(arr, np.float32)
            if arr.shape != (info.meta.nrows, 128):
                raise ValueError(f"bucket {info.key}: JAX {name} has shape "
                                 f"{arr.shape}, the port's bucket "
                                 f"({info.meta.nrows}, 128)")
            shards[name] = torch.from_numpy(
                np.ascontiguousarray(arr[lo:lo + rows])).to(device)
        if set(shards) != set(sd["buckets"][info.key]):
            raise ValueError(f"bucket {info.key}: JAX keys {sorted(shards)}, "
                             f"port keys {sorted(sd['buckets'][info.key])}")
        sd["buckets"][info.key] = shards
    sd["step"] = torch.tensor(int(np.asarray(state["step"])),
                              dtype=torch.int32, device=device)
    return sd
