"""GPT decoder for serving and training — port of ``apex_tpu/models/gpt.py``
(the serial path: prefill / decode, and the training loss).

The same pre-LN wiring as the JAX model: vocab embedding → N ×
(MixedFusedLayerNorm → causal attention with RoPE → residual →
MixedFusedLayerNorm → fc1 / tanh-GELU / fc2 → residual) → final
MixedFusedLayerNorm → tied head.  With ``fused_ffn=True`` the fc1 / GELU /
fc2 pair is the fused FFN op (the forward, dX and dW kernels of
:mod:`apex_tpu_torch.ops.fused_ffn`) on every path: loss, prefill and
decode.  Activations are
``(batch, seq, hidden)`` at ``cfg.dtype`` with f32 parameters.  Serving runs
the LayerNorm forward, the causal flash-attention forward (prefill) and the
single-query decode attention kernels; training (:meth:`GPTModel.loss`,
then ``backward``) runs the LayerNorm forward and backward and the flash
forward, dq and dk/dv kernels, with the attention-dropout mask of the JAX
model, all reached through :mod:`apex_tpu_torch.normalization` and
:mod:`apex_tpu_torch.ops`.  The training loss's head is the logit-free fused
LM head (``fused_lm_head=True``, the JAX default: the forward, dX and dW
kernels of :mod:`apex_tpu_torch.ops.lm_head` on compute-dtype operands), or
with ``fused_lm_head=False`` the f32 head GEMM and the vocab-parallel cross
entropy at world size 1.  Serving's logits are the f32 head GEMM.

Parameter names mirror the JAX parameter tree (``layers.3.attention.qkv.
weight`` is ``params["layers"][3]["attention"]["qkv"]["weight"]``), which
is what :func:`apex_tpu_torch.convert.gpt_params_from_jax` relies on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from apex_tpu_torch.normalization import MixedFusedLayerNorm
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_decode)
from apex_tpu_torch.ops.fused_ffn import fused_ffn
from apex_tpu_torch.ops.lm_head import fused_linear_cross_entropy
from apex_tpu_torch.ops.rope import (fused_apply_rotary_pos_emb_at_positions,
                                     fused_apply_rotary_pos_emb_cached,
                                     rope_freqs)
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.tensor_parallel.layers import INIT_STD
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32

REMAT_SLICE = "a later training slice (activation recompute)"
MULTI_GPU_SLICE = "the multi-GPU slice"
QUANT_SERVING_SLICE = "the paged/quantized serving slice"

# layer i's attention-dropout stream is seeded dropout_seed + i * stride
# (modulo 2**32), as in the JAX model: a caller advancing the base seed by
# +1 per step never replays another layer's mask
_SEED_LAYER_STRIDE = 0x3C6EF35F


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    max_seq_len: int = 1024
    ffn_hidden_size: Optional[int] = None      # default 4*hidden
    tensor_parallel_size: int = 1
    axis_name: Optional[str] = None            # "model" inside shard_map
    sequence_parallel: bool = False
    overlap_chunks: int = 0                    # >0: ring-overlapped TP GEMMs
    rotary: bool = True
    context_axis: Optional[str] = None
    context_mechanism: str = "ring"            # "ring" | "ulysses"
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    expert_axis: Optional[str] = None
    expert_parallel_size: int = 1
    attention_dropout: float = 0.0             # fused flash-kernel dropout
    fused_lm_head: bool = True                 # logit-free blockwise CE
    fused_ffn: bool = False
    weight_quant: Optional[str] = None
    remat: bool = False
    remat_policy: str = "full"                 # "full" | "dots"
    dtype: torch.dtype = _f32                  # activation/compute dtype
    param_dtype: torch.dtype = _f32
    plan: Optional[object] = None              # a ParallelPlan

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                "hidden_size must be divisible by num_attention_heads")
        if not 0.0 <= self.attention_dropout < 1.0:
            raise ValueError(f"attention_dropout must be in [0, 1), got "
                             f"{self.attention_dropout}")
        if self.context_mechanism not in ("ring", "ulysses"):
            raise ValueError(f"context_mechanism must be 'ring' or "
                             f"'ulysses', got {self.context_mechanism!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.overlap_chunks < 0:
            raise ValueError("overlap_chunks must be >= 0")
        if self.overlap_chunks > 0 and not self.sequence_parallel:
            raise ValueError("overlap_chunks > 0 rings the sequence-parallel "
                             "GEMMs; it requires sequence_parallel=True")
        if self.expert_axis is not None and self.n_experts <= 0:
            raise ValueError("expert_axis shards MoE experts; it requires "
                             "n_experts > 0")
        if self.fused_ffn and self.n_experts > 0:
            raise ValueError(
                "fused_ffn fuses the dense ParallelMLP pair; with "
                "n_experts > 0 every FFN slot is a MoEFFN and the knob "
                "would be silently dead — enable one or the other")
        if self.weight_quant is not None and self.fused_ffn:
            raise ValueError(
                "weight_quant routes the FFN through the int8 "
                "dequant-GEMMs, which fused_ffn would bypass (the fused "
                "kernel consumes raw f32/bf16 fc1/fc2 leaves) — enable "
                "one or the other")
        # every field of the JAX config is accepted at its default; a
        # value that needs a part not ported yet raises naming its slice
        unsupported = [
            (self.remat, "remat", REMAT_SLICE),
            (self.remat_policy != "full", "remat_policy", REMAT_SLICE),
            (self.weight_quant is not None, "weight_quant",
             QUANT_SERVING_SLICE),
            (self.plan is not None, "plan", MULTI_GPU_SLICE),
            (self.n_experts > 0, "n_experts > 0", MULTI_GPU_SLICE),
            (self.moe_top_k != 1, "moe_top_k", MULTI_GPU_SLICE),
            (self.moe_capacity_factor != 1.25, "moe_capacity_factor",
             MULTI_GPU_SLICE),
            (self.moe_aux_weight != 1e-2, "moe_aux_weight", MULTI_GPU_SLICE),
            (self.expert_axis is not None, "expert_axis", MULTI_GPU_SLICE),
            (self.expert_parallel_size != 1, "expert_parallel_size",
             MULTI_GPU_SLICE),
            (self.context_axis is not None, "context_axis", MULTI_GPU_SLICE),
            (self.context_mechanism != "ring", "context_mechanism",
             MULTI_GPU_SLICE),
            (self.axis_name is not None, "axis_name", MULTI_GPU_SLICE),
            (self.sequence_parallel, "sequence_parallel", MULTI_GPU_SLICE),
            (self.overlap_chunks > 0, "overlap_chunks", MULTI_GPU_SLICE),
            (self.tensor_parallel_size > 1, "tensor_parallel_size > 1",
             MULTI_GPU_SLICE),
        ]
        for on, knob, slice_name in unsupported:
            if on:
                raise NotImplementedError(
                    f"GPTConfig.{knob} is not ported yet: it comes with "
                    f"{slice_name} of apex_tpu_torch")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def local_heads(self):
        return self.num_attention_heads // self.tensor_parallel_size


class ParallelAttention(nn.Module):
    """Causal self-attention with fused QKV, RoPE and flash attention."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = tp.ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size,
            param_dtype=cfg.param_dtype, device=device)
        self.proj = tp.RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, param_dtype=cfg.param_dtype,
            device=device)

    def _qkv(self, x):
        """Project ``x`` and split into ``(q, k, v)``, each
        ``(b, s, local_heads, head_dim)``.  The heads are interleaved
        ``[q_h | k_h | v_h]`` along the projection, as in the JAX model:
        reshape to ``(b, s, nh, 3*hd)`` first, then split the last axis."""
        b = x.shape[0]
        qkv, _ = self.qkv(x)                      # (b, s, 3h)
        s = qkv.shape[1]
        hd = self.cfg.head_dim
        nh = qkv.shape[-1] // (3 * hd)
        return qkv.reshape(b, s, nh, 3 * hd).split(hd, dim=-1)

    def prefill(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        """Full-sequence causal attention that also returns the post-RoPE
        K/V in cache layout ``(b, s, local_heads, head_dim)``.
        ``dropout_seed`` turns on ``cfg.attention_dropout`` (no seed, no
        dropout, as in the JAX model)."""
        b = x.shape[0]
        q, k, v = self._qkv(x)                    # (b, s, nh, hd)
        s, nh = q.shape[1], q.shape[2]
        if rope_cos is not None:
            # the RoPE op takes (seq, batch, heads, dim)
            q = fused_apply_rotary_pos_emb_cached(
                q.transpose(0, 1), rope_cos, rope_sin).transpose(0, 1)
            k = fused_apply_rotary_pos_emb_cached(
                k.transpose(0, 1), rope_cos, rope_sin).transpose(0, 1)
        rate = self.cfg.attention_dropout if dropout_seed is not None \
            else 0.0
        ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, dropout=rate,
                              dropout_seed=dropout_seed)
        ctx = ctx.transpose(1, 2).reshape(b, s, nh * self.cfg.head_dim)
        out, _ = self.proj(ctx)
        return out, (k, v)

    def forward(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        out, _ = self.prefill(x, rope_cos, rope_sin, dropout_seed)
        return out

    def decode(self, x, cache, layer_index, positions, rope_cos=None,
               rope_sin=None):
        """One-token decode step against the KV cache ring.

        ``x``: ``(b, 1, hidden)``; ``cache``:
        ``(slots, layers, 2, max_seq, local_heads, head_dim)``;
        ``positions``: ``(b,)`` int, the position of the incoming token
        (== valid cache entries before this step); ``rope_cos/sin``:
        ``(max_seq, 1, 1, head_dim)`` tables.  Writes the new K/V at
        ``positions`` — IN PLACE, where the JAX model rebinds a donated
        buffer that XLA updates in place — then attends over
        ``positions + 1`` entries.  Returns ``(out (b, 1, hidden), cache)``.
        """
        b = x.shape[0]
        q, k, v = self._qkv(x)                    # (b, 1, nh, hd)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]       # (b, nh, hd)
        if rope_cos is not None:
            q = fused_apply_rotary_pos_emb_at_positions(q, rope_cos,
                                                        rope_sin, positions)
            k = fused_apply_rotary_pos_emb_at_positions(k, rope_cos,
                                                        rope_sin, positions)
        rows = torch.arange(b, device=x.device)
        cache[rows, layer_index, 0, positions] = k.to(cache.dtype)
        cache[rows, layer_index, 1, positions] = v.to(cache.dtype)
        # strided views of the ring: the decode kernel reads them as they are
        ctx = flash_attention_decode(q, cache[:, layer_index, 0],
                                     cache[:, layer_index, 1], positions + 1)
        out, _ = self.proj(ctx.reshape(b, 1, q.shape[1] * self.cfg.head_dim))
        return out, cache


class ParallelMLP(nn.Module):
    """Column → tanh-GELU → Row block (apex ParallelMLP): unfused, or with
    ``cfg.fused_ffn`` the fused op of :mod:`apex_tpu_torch.ops.fused_ffn`
    on the same ``fc1`` / ``fc2`` parameters."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.fused_ffn = cfg.fused_ffn
        self.fc1 = tp.ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size,
            param_dtype=cfg.param_dtype, device=device)
        self.fc2 = tp.RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, x):
        if self.fused_ffn:
            return fused_ffn(x, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias)
        h, _ = self.fc1(x)
        y, _ = self.fc2(F.gelu(h, approximate="tanh"))
        return y


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer block (apex ParallelTransformerLayer)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.input_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                   device=device)
        self.attention = ParallelAttention(cfg, device)
        self.post_attention_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                            device=device)
        self.mlp = ParallelMLP(cfg, device)

    def forward(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        x, _ = self.prefill(x, rope_cos, rope_sin, dropout_seed)
        return x

    def prefill(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        """Returns ``(x_out, (k, v))`` with this layer's post-RoPE cache
        entries."""
        attn, kv = self.attention.prefill(self.input_layernorm(x), rope_cos,
                                          rope_sin, dropout_seed)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), kv

    def decode(self, x, cache, layer_index, positions, rope_cos=None,
               rope_sin=None):
        attn, cache = self.attention.decode(
            self.input_layernorm(x), cache, layer_index, positions, rope_cos,
            rope_sin)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), cache


class GPTModel(nn.Module):
    """Decoder LM: embedding → N layers → final LN → tied head (f32 logits
    for serving; the fused LM head or the f32 logits for the loss).

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent (pass
    ``device="cpu"`` for the plain PyTorch path).  Parameters start at the
    deterministic values of a fresh ``nn.Module`` (zero weights, unit LN
    gains); :meth:`init_params` draws the random weights from a
    :class:`torch.Generator`, or load a state dict (for instance one from
    :func:`apex_tpu_torch.convert.gpt_params_from_jax`).
    """

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.device = resolve_device(device)
        # full-precision f32 products: the head GEMM (and the f32 reference
        # runs) must not drop to TF32's ~3 decimal digits, and bf16 GEMMs
        # reduce in f32 as the JAX dots do (preferred_element_type=f32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.cfg = cfg
        dev = self.device
        self.embedding = tp.VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, param_dtype=cfg.param_dtype,
            device=dev)
        self.layers = nn.ModuleList(ParallelTransformerLayer(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.final_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                   device=dev)
        if not cfg.rotary:
            self.position_embedding = nn.Parameter(torch.zeros(
                (cfg.max_seq_len, cfg.hidden_size), dtype=cfg.param_dtype,
                device=dev))
        self._rope = {}

    def init_params(self, generator: torch.Generator) -> "GPTModel":
        """Random weights as the JAX ``init_params`` draws them: every
        weight N(0, 0.02), biases 0, LayerNorm gains 1 and shifts 0.
        ``generator`` is a CPU :class:`torch.Generator` (the numbers are
        drawn on the CPU, so a seed gives the same model on every device;
        they cannot replay ``jax.random``)."""
        self.embedding.reset_parameters(generator)
        for layer in self.layers:
            for lin in (layer.attention.qkv, layer.attention.proj,
                        layer.mlp.fc1, layer.mlp.fc2):
                lin.reset_parameters(generator)
            for ln in (layer.input_layernorm, layer.post_attention_layernorm):
                _reset_layer_norm(ln)
        _reset_layer_norm(self.final_layernorm)
        if not self.cfg.rotary:
            with torch.no_grad():
                self.position_embedding.copy_(
                    torch.randn(self.position_embedding.shape,
                                generator=generator, dtype=_f32) * INIT_STD)
        return self

    def rope_tables(self, seq_len):
        """``(cos, sin)`` tables ``(seq_len, 1, 1, head_dim)`` f32, or
        ``(None, None)`` without RoPE; built once per length."""
        if not self.cfg.rotary:
            return None, None
        if seq_len not in self._rope:
            f = rope_freqs(seq_len, self.cfg.head_dim, device=self.device)
            self._rope[seq_len] = (torch.cos(f), torch.sin(f))
        return self._rope[seq_len]

    def embed(self, tokens):
        x = self.embedding(tokens)
        if not self.cfg.rotary:
            x = x + self.position_embedding[:tokens.shape[1]]
        return x.to(self.cfg.dtype)

    def _head_logits(self, x):
        """Tied-embedding head GEMM in full f32."""
        return torch.matmul(x.to(_f32), self.embedding.weight.to(_f32).t())

    def logits(self, x):
        """Final LN + tied head: ``(b, s, vocab)`` f32."""
        return self._head_logits(self.final_layernorm(x))

    def backbone(self, x, dropout_seed=None):
        """The layers over embedded ``x`` ``(b, s, hidden)``.  With a
        ``dropout_seed``, layer ``i`` drops attention probabilities with
        the stream ``dropout_seed + i * _SEED_LAYER_STRIDE``."""
        cos, sin = self.rope_tables(x.shape[1])
        for li, layer in enumerate(self.layers):
            seed = (None if dropout_seed is None
                    else int(dropout_seed) + li * _SEED_LAYER_STRIDE)
            x = layer(x, cos, sin, seed)
        return x

    def head_loss(self, x, targets):
        """Per-token cross entropy ``(b, s)`` f32 of the tied head on
        backbone output ``x``.

        With ``cfg.fused_lm_head`` (the default): final LN, then
        :func:`~apex_tpu_torch.ops.lm_head.fused_linear_cross_entropy` on
        operands at the compute dtype (the kernels dot at operand precision
        with f32 accumulation; the ``(b*s, vocab)`` logits never exist).
        The ``.to`` of the f32 tied weight is differentiable, so the
        kernel's bf16 dW flows into the f32 embedding's gradient.  At an f32
        ``cfg.dtype`` (the config's default) the kernels run their f32
        instantiation on the FMA units, about ten times the time of the f32
        head GEMMs on an H100 (PERF.md): an f32 model trains faster on the
        card with ``fused_lm_head=False``.  Else the f32 head GEMM, then
        :func:`~apex_tpu_torch.transformer.tensor_parallel.
        vocab_parallel_cross_entropy`."""
        b, s = targets.shape
        if self.cfg.fused_lm_head:
            h = self.final_layernorm(x)
            return fused_linear_cross_entropy(
                h.reshape(b * s, h.shape[-1]).to(self.cfg.dtype),
                self.embedding.weight.to(self.cfg.dtype),
                targets.reshape(b * s)).reshape(b, s)
        logits = self.logits(x)
        return tp.vocab_parallel_cross_entropy(
            logits.reshape(b * s, logits.shape[-1]),
            targets.reshape(b * s)).reshape(b, s)

    def loss(self, tokens, targets, dropout_seed=None):
        """Mean next-token loss (f32 scalar) of ``tokens (b, s)`` against
        ``targets (b, s)``; differentiable in every parameter.
        ``dropout_seed`` (int) enables ``cfg.attention_dropout`` for this
        step (advance it by +1 per step); ``None`` means no dropout."""
        x = self.backbone(self.embed(tokens), dropout_seed)
        return torch.mean(self.head_loss(x, targets))

    def forward(self, tokens, dropout_seed=None):
        """Full causal forward: ``tokens (b, s)`` → logits ``(b, s, vocab)``
        f32; differentiable."""
        return self.logits(self.backbone(self.embed(tokens), dropout_seed))

    @torch.no_grad()
    def prefill(self, tokens):
        """Process a full prompt; returns ``(logits, kv)``.

        ``logits``: ``(b, s, vocab)`` f32; ``kv``: ``(layers, 2, b, s,
        local_heads, head_dim)`` post-RoPE cache entries in the compute
        dtype, for :meth:`apex_tpu_torch.inference.KVCache.write_prompt`.
        Prompts padded beyond their true length are safe: causal masking
        keeps the logits at positions ``< prompt_len`` unaffected.
        """
        x = self.embed(tokens)
        cos, sin = self.rope_tables(tokens.shape[1])
        ks, vs = [], []
        for layer in self.layers:
            x, (k, v) = layer.prefill(x, cos, sin)
            ks.append(k)
            vs.append(v)
        kv = torch.stack([torch.stack(ks), torch.stack(vs)], dim=1)
        return self.logits(x), kv

    @torch.no_grad()
    def decode_step(self, tokens, cache, positions):
        """One batched autoregressive step over the cache ring.

        ``tokens``: ``(slots,)`` int; ``cache``: ``(slots, layers, 2,
        max_seq, local_heads, head_dim)``, updated in place; ``positions``:
        ``(slots,)`` int, each token's absolute position.  Returns
        ``(logits (slots, vocab) f32, cache)``.  Inactive slots compute
        garbage that is never read.
        """
        x = self.embedding(tokens[:, None])
        if not self.cfg.rotary:
            x = x + self.position_embedding[positions][:, None]
        x = x.to(self.cfg.dtype)
        cos, sin = self.rope_tables(cache.shape[3])
        for li, layer in enumerate(self.layers):
            x, cache = layer.decode(x, cache, li, positions, cos, sin)
        x = self.final_layernorm(x)
        return self._head_logits(x[:, 0]), cache


def _reset_layer_norm(ln) -> None:
    with torch.no_grad():
        ln.weight.fill_(1.0)
        if ln.bias is not None:
            ln.bias.zero_()
