"""BERT encoder with MLM/NSP heads — port of ``apex_tpu/models/bert.py``
(the serial path: ``apply``, the MLM head and the training loss).

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

Parameter names and shapes mirror the JAX tree (``layers.3.attention.qkv.
weight`` is ``params["layers"][3]["attention"]["qkv"]["weight"]``), so the
conversion is a flatten and amp's O2 name pattern sees the same names.  As
in JAX, the TP linears keep ``(out, in)`` weights used as ``x @ W.T``, and
the MLM transform and NSP head keep ``(in, out)`` weights used as
``x @ W``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import (MULTI_GPU_SLICE, _reset_layer_norm,
                                       remat_call)
from apex_tpu_torch.normalization import MixedFusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.fused_ffn import fused_ffn
from apex_tpu_torch.ops.lm_head import fused_linear_cross_entropy
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.tensor_parallel.layers import _normal_
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertModel"]


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
    plan: Optional[object] = None

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                "hidden_size must be divisible by num_attention_heads")
        unsupported = [
            (self.plan is not None, "plan", MULTI_GPU_SLICE),
            (self.tensor_parallel_size > 1, "tensor_parallel_size > 1",
             MULTI_GPU_SLICE),
            (self.axis_name is not None, "axis_name", MULTI_GPU_SLICE),
            (self.sequence_parallel, "sequence_parallel", MULTI_GPU_SLICE),
            (self.overlap_chunks > 0, "overlap_chunks", MULTI_GPU_SLICE),
        ]
        for on, knob, slice_name in unsupported:
            if on:
                raise NotImplementedError(
                    f"BertConfig.{knob} is not ported yet: it comes with "
                    f"{slice_name} of apex_tpu_torch")

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
            cfg.hidden_size, 3 * cfg.hidden_size,
            param_dtype=cfg.param_dtype, device=device)
        self.proj = tp.RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, param_dtype=cfg.param_dtype,
            device=device)

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
        self.fused_ffn = cfg.fused_ffn
        self.attention = BertSelfAttention(cfg, device)
        self.attention_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                       device=device)
        self.fc1 = tp.ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size,
            param_dtype=cfg.param_dtype, device=device)
        self.fc2 = tp.RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size,
            param_dtype=cfg.param_dtype, device=device)
        self.output_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                    device=device)

    def forward(self, x, seqlens=None):
        x = self.attention_layernorm(x + self.attention(x, seqlens))
        if self.fused_ffn:
            h = fused_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                          self.fc2.bias)
        else:
            h, _ = self.fc1(x)
            h, _ = self.fc2(F.gelu(h, approximate="tanh"))
        return self.output_layernorm(x + h)


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

    def forward(self, x):
        return x.to(_f32) @ self.weight.to(_f32) + self.bias.to(_f32)


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
            cfg.vocab_size, cfg.hidden_size, param_dtype=cfg.param_dtype,
            device=dev)
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
        x = self.embedding(tokens)
        x = x + self.position_embedding[:tokens.shape[1]]
        if token_type_ids is None:
            x = x + self.token_type_embedding[0]
        else:
            x = x + self.token_type_embedding[token_type_ids]
        x = self.embedding_layernorm(x).to(self.cfg.dtype)
        for layer in self.layers:
            x = remat_call(self.cfg, layer, x, seqlens)
        return x

    forward = apply

    def _mlm_transform(self, hidden):
        """f32 dense + GELU + LN before the tied decoder."""
        h = F.gelu(self.mlm_transform(hidden), approximate="tanh")
        return self.mlm_layernorm(h)

    def mlm_logits(self, hidden):
        """Tied-decoder logits ``(b, s, vocab)`` in full f32."""
        h = self._mlm_transform(hidden)
        return torch.matmul(h.to(_f32), self.embedding.weight.to(_f32).t())

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
        hidden = self.apply(tokens, token_type_ids, seqlens)
        b, s = mlm_labels.shape
        mask = mlm_labels >= 0
        safe = torch.where(mask, mlm_labels, torch.zeros_like(mlm_labels))
        if self.cfg.fused_lm_head:
            h = self._mlm_transform(hidden)
            per = fused_linear_cross_entropy(
                h.reshape(b * s, h.shape[-1]).to(self.cfg.dtype),
                self.embedding.weight.to(self.cfg.dtype),
                safe.reshape(b * s)).reshape(b, s)
        else:
            logits = self.mlm_logits(hidden)
            per = tp.vocab_parallel_cross_entropy(
                logits.reshape(b * s, logits.shape[-1]),
                safe.reshape(b * s)).reshape(b, s)
        denom = torch.clamp(torch.sum(mask), min=1)
        loss = torch.sum(torch.where(mask, per, torch.zeros_like(per))) \
            / denom
        if nsp_labels is not None:
            pooled = torch.tanh(hidden[:, 0].to(_f32))
            logp = torch.log_softmax(self.nsp_head(pooled), dim=-1)
            loss = loss - torch.mean(
                torch.gather(logp, 1, nsp_labels.reshape(-1, 1)))
        return loss
