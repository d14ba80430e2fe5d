"""BERT encoder with MLM/NSP heads — port of ``apex_tpu/models/bert.py``
(``apply``, the MLM head and the training loss, serial or tensor- and
sequence-parallel).

The JAX model's wiring: token (vocab) + learned position + segment
embeddings → MixedFusedLayerNorm → N × post-LN blocks (bidirectional flash
attention with ``seqlens`` as the kernel's ``kv_seqlens`` → residual → LN →
fc1 / tanh-GELU / fc2, or with ``fused_ffn=True`` the fused FFN op of
:mod:`apex_tpu_torch.ops.fused_ffn` → residual → LN) → MLM transform (f32
dense + GELU + LN) → tied decoder → cross entropy over the masked
positions (labels ``-1`` elsewhere), plus the NSP head when labels are
given.  The decoder and its
cross entropy are the logit-free fused LM head (``fused_lm_head=True``, the
JAX default: :mod:`apex_tpu_torch.ops.lm_head` on compute-dtype operands),
or with ``fused_lm_head=False`` the f32 decoder GEMM and the vocab-parallel
cross entropy.  Training runs the LayerNorm forward and backward and the
non-causal flash forward, dq and dk/dv kernels through
:mod:`apex_tpu_torch.normalization` and :mod:`apex_tpu_torch.ops`.
``remat=True`` recomputes each layer in the backward as the GPT model
does (:func:`apex_tpu_torch.models.gpt.remat_call`, both policies).

Tensor and sequence parallelism (``tensor_parallel_size=t,
axis_name="model"``, ``sequence_parallel``, ``overlap_chunks``) are the
GPT model's (:mod:`apex_tpu_torch.models.gpt`): the linears and the
embedding hold their rank's shards, the MLM loss is the vocab-parallel
logits and cross entropy, and under sequence parallelism the layers run
on the sequence shard, the per-layer LayerNorms and the MLM transform and
LayerNorm (which see the vocab shard's partial gradient) taking
``copy_to_tensor_model_parallel_region`` on their parameters.  Outside it
the decoder's f32 input is copied into the region.
:func:`shard_params_for_tp` cuts a serial state dict by the models'
partition specs.

Parameter names and shapes mirror the JAX tree (``layers.3.attention.qkv.
weight`` is ``params["layers"][3]["attention"]["qkv"]["weight"]``), so the
conversion is a flatten and amp's O2 name pattern sees the same names.  As
in JAX, the TP linears keep ``(out, in)`` weights used as ``x @ W.T``, and
the MLM transform and NSP head keep ``(in, out)`` weights used as
``x @ W``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import (_reset_layer_norm,
                                       fused_ffn_tp_of, remat_call,
                                       shard_state_dict, sp_param_map,
                                       tp_layer_kwargs)
from apex_tpu_torch.normalization import MixedFusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.lm_head import fused_linear_cross_entropy
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.tensor_parallel.layers import _normal_
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertModel",
           "shard_params_for_tp"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30528                    # MLPerf padded vocab
    hidden_size: int = 1024                    # BERT-large
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_len: int = 512
    type_vocab_size: int = 2
    fused_lm_head: bool = True                 # logit-free blockwise CE
    ffn_hidden_size: Optional[int] = None      # default 4*hidden
    tensor_parallel_size: int = 1
    axis_name: Optional[str] = None
    sequence_parallel: bool = False
    overlap_chunks: int = 0
    fused_ffn: bool = False
    remat: bool = False
    remat_policy: str = "full"                 # "full" | "dots"
    dtype: torch.dtype = _f32                  # activation/compute dtype
    param_dtype: torch.dtype = _f32
    # a ParallelPlan: same supersede-with-warning semantics as GPTConfig.plan
    plan: Optional[object] = None

    def __post_init__(self):
        if self.plan is not None:
            from apex_tpu_torch.parallel.plan import apply_plan_to_config
            apply_plan_to_config(self)
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                "hidden_size must be divisible by num_attention_heads")
        if self.num_attention_heads % self.tensor_parallel_size:
            raise ValueError("num_attention_heads must be divisible by "
                             "tensor_parallel_size")
        if self.overlap_chunks < 0:
            raise ValueError(
                f"overlap_chunks must be >= 0, got {self.overlap_chunks}")
        if self.overlap_chunks > 0 and not self.sequence_parallel:
            raise ValueError(
                "overlap_chunks rings the sequence-parallel collective/GEMM "
                "pairs; it requires sequence_parallel=True")
        if self.tensor_parallel_size > 1 and self.axis_name is None:
            raise ValueError(
                "tensor_parallel_size > 1 needs axis_name (the model "
                "process group): the port has no GSPMD form, its layers "
                "hold their rank's shards")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class BertSelfAttention(nn.Module):
    """Bidirectional self-attention; padding through the flash kernels'
    ``kv_seqlens`` (the reference fmha's cu_seqlens)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = tp.ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, gather_output=False,
            device=device, **tp_layer_kwargs(cfg))
        self.proj = tp.RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, input_is_parallel=True,
            device=device, **tp_layer_kwargs(cfg))

    def forward(self, x, seqlens=None):
        b = x.shape[0]
        qkv, _ = self.qkv(x)                      # (b, s, 3h)
        s = qkv.shape[1]
        hd = self.cfg.head_dim
        nh = qkv.shape[-1] // (3 * hd)
        # heads interleaved [q_h | k_h | v_h], as in the JAX model
        q, k, v = qkv.reshape(b, s, nh, 3 * hd).split(hd, dim=-1)
        ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False,
                              kv_seqlens=seqlens)
        out, _ = self.proj(ctx.transpose(1, 2).reshape(b, s, nh * hd))
        return out


class BertLayer(nn.Module):
    """Post-LN block (the original BERT arrangement: residual → LN)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fused_ffn = cfg.fused_ffn
        self.attention = BertSelfAttention(cfg, device)
        self.attention_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                       device=device)
        self.fc1 = tp.ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size, gather_output=False,
            device=device, **tp_layer_kwargs(cfg))
        self.fc2 = tp.RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size, input_is_parallel=True,
            device=device, **tp_layer_kwargs(cfg))
        self.output_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                    device=device)

    def forward(self, x, seqlens=None):
        wrap = sp_param_map(self.cfg)
        x = self.attention_layernorm(x + self.attention(x, seqlens), wrap)
        if self.fused_ffn:
            h = fused_ffn_tp_of(self.cfg, x, self.fc1, self.fc2)
        else:
            h, _ = self.fc1(x)
            h, _ = self.fc2(F.gelu(h, approximate="tanh"))
        return self.output_layernorm(x + h, wrap)


class _Dense(nn.Module):
    """An ``(in, out)`` weight and a bias, used as ``x @ W + b`` in f32 (the
    MLM transform and the NSP head of the JAX model)."""

    def __init__(self, n_in, n_out, param_dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((n_in, n_out),
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros((n_out,), dtype=param_dtype,
                                             device=device))

    def forward(self, x, param_map=None):
        weight, bias = self.weight, self.bias
        if param_map is not None:
            weight, bias = param_map(weight), param_map(bias)
        return x.to(_f32) @ weight.to(_f32) + bias.to(_f32)


class BertModel(nn.Module):
    """Encoder + MLM/NSP heads.

    ``apply(tokens, token_type_ids=None, seqlens=None)`` returns the final
    hidden states ``(b, s, hidden)`` at ``cfg.dtype``; :meth:`loss`
    computes the MLM (+ optional NSP) loss over the tied decoder (the
    fused LM head, or the f32 logits and vocab-parallel cross entropy).
    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent (pass
    ``device="cpu"`` for the plain PyTorch path).  Parameters start as a
    fresh ``nn.Module``'s (zero weights, unit LN gains); :meth:`init_params`
    draws random weights, or load a state dict (for instance one from
    :func:`apex_tpu_torch.convert.bert_params_from_jax`).
    """

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.device = resolve_device(device)
        # full f32 products for the f32 head and the f32 reference runs;
        # bf16 GEMMs reduce in f32 as the JAX dots do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.cfg = cfg
        dev = self.device
        self.embedding = tp.VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            world_size=cfg.tensor_parallel_size, axis_name=cfg.axis_name,
            param_dtype=cfg.param_dtype, device=dev)
        self.position_embedding = nn.Parameter(torch.zeros(
            (cfg.max_seq_len, cfg.hidden_size), dtype=cfg.param_dtype,
            device=dev))
        self.token_type_embedding = nn.Parameter(torch.zeros(
            (cfg.type_vocab_size, cfg.hidden_size), dtype=cfg.param_dtype,
            device=dev))
        self.embedding_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                       device=dev)
        self.layers = nn.ModuleList(BertLayer(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.mlm_transform = _Dense(cfg.hidden_size, cfg.hidden_size,
                                    cfg.param_dtype, dev)
        self.mlm_layernorm = MixedFusedLayerNorm(cfg.hidden_size, device=dev)
        self.nsp_head = _Dense(cfg.hidden_size, 2, cfg.param_dtype, dev)

    def init_params(self, generator: torch.Generator) -> "BertModel":
        """Random weights as the JAX ``init_params`` draws them: the
        embeddings, the linears and the MLM transform N(0, 0.02), biases 0,
        LayerNorm gains 1 and shifts 0, the NSP head 0.  ``generator`` is a
        CPU :class:`torch.Generator` (a seed gives the same model on every
        device; it cannot replay ``jax.random``)."""
        self.embedding.reset_parameters(generator)
        _normal_(self.position_embedding, generator)
        _normal_(self.token_type_embedding, generator)
        for layer in self.layers:
            for lin in (layer.attention.qkv, layer.attention.proj,
                        layer.fc1, layer.fc2):
                lin.reset_parameters(generator)
            _reset_layer_norm(layer.attention_layernorm)
            _reset_layer_norm(layer.output_layernorm)
        for ln in (self.embedding_layernorm, self.mlm_layernorm):
            _reset_layer_norm(ln)
        _normal_(self.mlm_transform.weight, generator)
        with torch.no_grad():
            for t in (self.mlm_transform.bias, self.nsp_head.weight,
                      self.nsp_head.bias):
                t.zero_()
        return self

    def apply(self, tokens, token_type_ids=None, seqlens=None):
        """Final hidden states ``(b, s, hidden)`` at ``cfg.dtype``.
        ``seqlens``: optional ``(b,)`` int valid lengths (keys past them
        are masked)."""
        return self._gather(self._encode(tokens, token_type_ids, seqlens))

    forward = apply

    @property
    def _sp(self):
        return self.cfg.sequence_parallel and self.cfg.axis_name is not None

    def _gather(self, x):
        """The whole sequence of an encoder output (reduce-scatter
        backward under sequence parallelism)."""
        if not self._sp:
            return x
        return tp.gather_from_sequence_parallel_region(
            x, self.cfg.axis_name, 1)

    def _encode(self, tokens, token_type_ids, seqlens):
        """The encoder's output, under sequence parallelism this rank's
        sequence shard ``(b, s / t, hidden)``."""
        x = self.embedding(tokens)
        x = x + self.position_embedding[:tokens.shape[1]]
        if token_type_ids is None:
            x = x + self.token_type_embedding[0]
        else:
            x = x + self.token_type_embedding[token_type_ids]
        x = self.embedding_layernorm(x).to(self.cfg.dtype)
        cfg = self.cfg
        if self._sp:
            # the per-layer LNs and residuals run on (b, s/t, h); each
            # block's tensor-parallel edges gather / reduce-scatter
            if tokens.shape[1] % cfg.tensor_parallel_size:
                raise ValueError(
                    f"sequence_parallel requires seq_len divisible by "
                    f"tensor_parallel_size ({tokens.shape[1]} % "
                    f"{cfg.tensor_parallel_size} != 0)")
            x = tp.scatter_to_sequence_parallel_region(x, cfg.axis_name, 1)
        for layer in self.layers:
            x = remat_call(cfg, layer, x, seqlens)
        return x

    def _mlm_transform(self, hidden):
        """f32 dense + GELU + LN before the tied decoder; under sequence
        parallelism their parameters see the vocab shard's partial
        gradient and are wrapped (:func:`~apex_tpu_torch.models.gpt.
        sp_param_map`)."""
        wrap = sp_param_map(self.cfg)
        h = F.gelu(self.mlm_transform(hidden, wrap), approximate="tanh")
        return self.mlm_layernorm(h, wrap)

    def mlm_logits(self, hidden):
        """Tied-decoder logits ``(b, s, vocab / t)`` in full f32 (this
        rank's vocab shard; outside sequence parallelism the decoder's
        input is copied into the tensor-parallel region)."""
        h = self._mlm_transform(hidden).to(_f32)
        if self.cfg.axis_name is not None and not self.cfg.sequence_parallel:
            h = tp.copy_to_tensor_model_parallel_region(h, self.cfg.axis_name)
        return torch.matmul(h, self.embedding.weight.to(_f32).t())

    def loss(self, tokens, mlm_labels, token_type_ids=None, seqlens=None,
             nsp_labels=None):
        """Mean MLM loss over the masked positions (+ the NSP loss when
        ``nsp_labels`` are given), an f32 scalar.  ``mlm_labels``: the
        original ids at masked positions, ``-1`` elsewhere.

        With ``cfg.fused_lm_head`` the MLM transform's f32 output and the
        tied embedding go to the fused LM head at ``cfg.dtype`` (under O2
        the embedding is bf16 already); unmasked positions take target 0
        and are masked out below, so their rows carry a zero cotangent
        into the dX and dW kernels.  At an f32 ``cfg.dtype`` the kernels
        run their f32 instantiation (see :meth:`GPTModel.head_loss
        <apex_tpu_torch.models.gpt.GPTModel.head_loss>`: slower on the card
        than ``fused_lm_head=False``)."""
        x = self._encode(tokens, token_type_ids, seqlens)
        hidden = self._gather(x)
        b, s = mlm_labels.shape
        mask = mlm_labels >= 0
        safe = torch.where(mask, mlm_labels, torch.zeros_like(mlm_labels))
        if self.cfg.axis_name is None and self.cfg.fused_lm_head:
            h = self._mlm_transform(hidden)
            per = fused_linear_cross_entropy(
                h.reshape(b * s, h.shape[-1]).to(self.cfg.dtype),
                self.embedding.weight.to(self.cfg.dtype),
                safe.reshape(b * s)).reshape(b, s)
        else:
            logits = self.mlm_logits(hidden)
            per = tp.vocab_parallel_cross_entropy(
                logits.reshape(b * s, logits.shape[-1]),
                safe.reshape(b * s),
                axis_name=self.cfg.axis_name).reshape(b, s)
        denom = torch.clamp(torch.sum(mask), min=1)
        loss = torch.sum(torch.where(mask, per, torch.zeros_like(per))) \
            / denom
        if nsp_labels is not None:
            first = hidden[:, 0]
            if self._sp:
                # every rank computes the same NSP loss: gather each
                # shard's first token with a split backward (the global
                # first token is rank 0's), so its cotangent reaches the
                # encoder once and not once a rank.  The JAX package sums
                # it over the ranks (ROADMAP queue C)
                first = tp.gather_from_sequence_parallel_region(
                    x[:, :1], self.cfg.axis_name, 1,
                    tensor_parallel_output_grad=False)[:, 0]
            pooled = torch.tanh(first.to(_f32))
            logp = torch.log_softmax(self.nsp_head(pooled), dim=-1)
            loss = loss - torch.mean(
                torch.gather(logp, 1, nsp_labels.reshape(-1, 1)))
        return loss


_COLUMN_SHARDED = re.compile(
    r"(embedding|layers\.\d+\.(attention\.qkv|fc1))\.(weight|bias)")
_ROW_SHARDED = re.compile(r"layers\.\d+\.(attention\.proj|fc2)\.weight")


def shard_params_for_tp(cfg: BertConfig, state_dict, rank: int) -> dict:
    """Rank ``rank``'s tensor-parallel state dict cut from a serial
    :class:`BertModel` state dict by the JAX model's ``partition_specs``
    (``apex_tpu/models/bert.py:333``): the embedding's and the column
    layers' (qkv, fc1) rows, the row layers' (proj, fc2) weight columns;
    everything else whole."""
    return shard_state_dict(state_dict, rank, cfg.tensor_parallel_size,
                            _COLUMN_SHARDED, _ROW_SHARDED)
