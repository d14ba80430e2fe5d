"""GPT decoder for serving and training — port of ``apex_tpu/models/gpt.py``
(prefill / decode and the training loss, serial or tensor-, sequence-,
expert-, context- or pipeline-parallel).

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
entropy.  Serving's logits are the f32 head GEMM.
With ``remat=True`` each layer of the training path runs under
``torch.utils.checkpoint`` (:func:`remat_call`): ``remat_policy="full"``
keeps only the layer's input and recomputes the whole layer in the
backward, "dots" also keeps the four linear products (qkv, proj, fc1,
fc2) and recomputes the rest, LayerNorm and flash forward kernels
included.  The recompute draws the same attention-dropout mask: the flash
kernels' mask is a hash of the seed and the position.

The decode methods come in two cache layouts: the contiguous slot ring of
:class:`apex_tpu_torch.inference.KVCache` (:meth:`GPTModel.decode_step`,
the single-query decode kernel) and the paged block pool of
:class:`apex_tpu_torch.serving.PagedKVCache` (:meth:`GPTModel.
decode_step_paged`, the paged decode kernel; :meth:`GPTModel.decode_chunk`
for chunked prefill and speculative verification), plus the int8 pool's
``*_quant`` variants, whose attention is plain PyTorch as in JAX.  Pools
and rings are updated in place.  With ``weight_quant="int8"`` the serving
engines quantize the weights once (:func:`quantize_decode_params`,
:meth:`GPTModel.load_quantized_`): every qkv / proj / fc1 / fc2 GEMM and
the tied head then run the int8 dequant-GEMM kernel of
:mod:`apex_tpu_torch.ops.quant_gemm`, and training refuses the model.

Tensor parallelism (``tensor_parallel_size=t, axis_name="model"``, the
JAX model's shard_map form) runs over the ``model`` process group of
:mod:`apex_tpu_torch.transformer.parallel_state`: each rank holds the
column shards of qkv and fc1, the row shards of proj and fc2, the vocab
rows of the tied embedding and its ``local_heads`` heads, and the head
loss is the f32 vocab-parallel logits and cross entropy (the fused LM head
serves the serial vocab only, as in JAX).  ``sequence_parallel=True``
shards the residual stream along the sequence between the layers'
tensor-parallel regions (:meth:`GPTModel.loss` scatters it after the
embedding and gathers it before the head); ``overlap_chunks > 0`` takes
the overlap rings for the linears.  Torch sums no gradient across ranks by
itself (JAX's shard_map psums a replicated leaf's cotangents): what
rank-local work uses of the replicated stream takes
``copy_to_tensor_model_parallel_region`` (identity forward, all-reduce
backward) — under sequence parallelism the LayerNorms' parameters, the
row biases and the final LayerNorm's, outside it the head's input (each
rank's head sees its vocab shard only) — so every rank holds the serial
gradient of a replicated parameter and the slice of it of a sharded one.
With attention dropout rank ``r`` adds ``r * _SEED_TP_RANK_STRIDE`` to the
seed (int32 wraparound, as in JAX): the kernels' mask hashes the local
head index.  :func:`shard_params_for_tp` cuts a serial state dict into
rank ``r``'s.

With ``n_experts > 0`` every FFN slot is a Switch / GShard mixture of
experts (:class:`MoEFFN`, the port of :mod:`apex_tpu_torch.transformer.
expert_parallel`'s ``MoEMLP``; its experts over the ``expert`` group with
``expert_axis``), and the loss adds ``moe_aux_weight * aux / num_layers``;
the serving paths route every token too (a decode step's few tokens meet a
capacity of 1 and may be dropped, as in JAX).  With ``context_axis`` each
rank holds a shard of the sequence: attention is ring or Ulysses
(:mod:`apex_tpu_torch.transformer.context_parallel`), RoPE and learned
positions start at the shard's global offset, and the loss is the mean
over the group.  :func:`pipeline_step` trains a pipeline rank's stage model
(``pipeline_stage=``) on the ring engine of :mod:`apex_tpu_torch.
transformer.pipeline_parallel`.  The JAX ``pack_for_shard_map`` /
``unpack_from_shard_map`` pack a whole parameter tree for one
``shard_map`` (GSPMD bookkeeping): here each rank loads its own part,
which :func:`apex_tpu_torch.convert.gpt_params_from_jax` (``rank=``,
``expert_rank=``, ``pipeline_stage=``) and :func:`stage_state_dict` cut.

Parameter names mirror the JAX parameter tree (``layers.3.attention.qkv.
weight`` is ``params["layers"][3]["attention"]["qkv"]["weight"]``), which
is what :func:`apex_tpu_torch.convert.gpt_params_from_jax` relies on.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import types
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.normalization import MixedFusedLayerNorm
from apex_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_chunk_paged, flash_attention_decode,
    flash_attention_decode_paged, flash_attention_decode_paged_quant,
    quantize_kv_blocks)
from apex_tpu_torch.ops.fused_ffn import fused_ffn_tp
from apex_tpu_torch.ops.lm_head import fused_linear_cross_entropy
from apex_tpu_torch.ops.quant_gemm import quant_gemm, quantize_weight
from apex_tpu_torch.ops.rope import (fused_apply_rotary_pos_emb_at_positions,
                                     fused_apply_rotary_pos_emb_cached,
                                     rope_freqs)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.expert_parallel import MoEConfig, MoEMLP
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    INIT_STD, install_int8_weight)
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_group
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32

# layer i's attention-dropout stream is seeded dropout_seed + i * stride
# (modulo 2**32), as in the JAX model: a caller advancing the base seed by
# +1 per step never replays another layer's mask
_SEED_LAYER_STRIDE = 0x3C6EF35F
_SEED_MB_STRIDE = 0x5BD1E995       # per-micro-batch stream (the pipeline)
_SEED_TP_RANK_STRIDE = 0x7F4A7C15  # per-TP-rank dropout stream offset


def wrap_int32(v: int) -> int:
    """``v`` wrapped into int32 as JAX's int32 arithmetic wraps it."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def sp_param_map(cfg):
    """The map the sequence-parallel regions apply to a replicated
    parameter (``copy_to_tensor_model_parallel_region``: its gradient
    summed over the ranks), or None outside sequence parallelism."""
    if not (cfg.sequence_parallel and cfg.axis_name is not None):
        return None
    return functools.partial(tp.copy_to_tensor_model_parallel_region,
                             axis_name=cfg.axis_name)


def tp_layer_kwargs(cfg):
    """The tensor-parallel keywords every linear of the models takes (the
    JAX models' wiring)."""
    return dict(world_size=cfg.tensor_parallel_size, axis_name=cfg.axis_name,
                sequence_parallel_enabled=cfg.sequence_parallel, seq_dim=1,
                overlap_chunks=cfg.overlap_chunks,
                param_dtype=cfg.param_dtype)


def _remat_policy(name: str):
    """``torch.utils.checkpoint`` ``context_fn`` for a ``remat_policy``
    name (the JAX ``_remat_policy``): None for "full" (save nothing),
    and for "dots" selective checkpointing that saves the outputs of the
    2-D products ``aten.mm`` / ``aten.addmm`` — what JAX's
    ``dots_with_no_batch_dims_saveable`` keeps — and recomputes everything
    else: ``aten.bmm`` (it has a batch dim) and the kernels, whose
    launches dispatch cannot see into, as JAX recomputes a ``pallas_call``
    under that policy."""
    if name != "dots":
        return None
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError as e:
        raise RuntimeError(
            "remat_policy='dots' needs torch.utils.checkpoint."
            "create_selective_checkpoint_contexts and CheckpointPolicy, "
            f"which PyTorch {torch.__version__} lacks") from e
    saved = (torch.ops.aten.mm, torch.ops.aten.addmm)

    def dots(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, dots)


def remat_call(cfg, layer, *args):
    """``layer(*args)``, through ``torch.utils.checkpoint`` under
    ``cfg.remat`` while autograd records (JAX ``jax.checkpoint`` with
    ``_remat_policy``): the layer's activations are recomputed in the
    backward instead of kept."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(*args)
    context_fn = _remat_policy(cfg.remat_policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(layer, *args, use_reentrant=False, **kwargs)


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
    # one validated ParallelPlan instead of the per-knob fields above: the
    # tp / SP / overlap / fused-FFN / remat knobs are filled from it (the
    # plan wins a conflict, with a DeprecationWarning)
    plan: Optional[object] = None

    def __post_init__(self):
        if self.plan is not None:
            from apex_tpu_torch.parallel.plan import apply_plan_to_config
            apply_plan_to_config(self)
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                "hidden_size must be divisible by num_attention_heads")
        if self.num_attention_heads % self.tensor_parallel_size:
            raise ValueError(
                "num_attention_heads must be divisible by "
                "tensor_parallel_size")
        if self.tensor_parallel_size > 1 and self.axis_name is None:
            raise ValueError(
                "tensor_parallel_size > 1 needs axis_name (the model "
                "process group): the port has no GSPMD form, its layers "
                "hold their rank's shards")
        if not 0.0 <= self.attention_dropout < 1.0:
            raise ValueError(f"attention_dropout must be in [0, 1), got "
                             f"{self.attention_dropout}")
        if self.context_mechanism not in ("ring", "ulysses"):
            raise ValueError(f"context_mechanism must be 'ring' or "
                             f"'ulysses', got {self.context_mechanism!r}")
        if self.n_experts > 0 and (
                self.ffn_hidden_size % self.tensor_parallel_size):
            raise ValueError(
                "MoE ffn_hidden_size must be divisible by "
                "tensor_parallel_size (each expert's FFN dim is "
                "Column/Row-sharded over the tensor axis)")
        if self.attention_dropout > 0.0 and self.context_axis is not None:
            raise ValueError(
                "attention_dropout is not supported with context "
                "parallelism (the ring/ulysses kernels take no dropout)")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.overlap_chunks < 0:
            raise ValueError("overlap_chunks must be >= 0")
        if self.overlap_chunks > 0 and not self.sequence_parallel:
            raise ValueError("overlap_chunks > 0 rings the sequence-parallel "
                             "GEMMs; it requires sequence_parallel=True")
        if self.sequence_parallel and self.context_axis is not None:
            raise ValueError(
                "sequence_parallel and context parallelism both shard the "
                "sequence dimension; enable one or the other")
        if self.sequence_parallel and self.n_experts > 0:
            raise ValueError(
                "sequence_parallel does not compose with MoE FFNs: the "
                "router's TP-internal psum assumes every tensor rank sees "
                "the same (replicated) tokens, but SP shards them")
        if self.expert_axis is not None and self.n_experts <= 0:
            raise ValueError("expert_axis shards MoE experts; it requires "
                             "n_experts > 0")
        if self.fused_ffn and self.n_experts > 0:
            raise ValueError(
                "fused_ffn fuses the dense ParallelMLP pair; with "
                "n_experts > 0 every FFN slot is a MoEFFN and the knob "
                "would be silently dead — enable one or the other")
        if self.weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got "
                             f"{self.weight_quant!r}")
        if self.weight_quant is not None and self.n_experts > 0:
            raise ValueError(
                "weight_quant covers the dense qkv/proj/fc1/fc2/lm-head "
                "GEMMs; MoE expert stacks (n_experts > 0) keep their own "
                "3D weight layout that quantize_decode_params does not "
                "produce — disable one or the other")
        if self.weight_quant is not None and self.fused_ffn:
            raise ValueError(
                "weight_quant routes the FFN through the int8 "
                "dequant-GEMMs, which fused_ffn would bypass (the fused "
                "kernel consumes raw f32/bf16 fc1/fc2 leaves) — enable "
                "one or the other")
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
            cfg.hidden_size, 3 * cfg.hidden_size, gather_output=False,
            device=device, **tp_layer_kwargs(cfg))
        self.proj = tp.RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, input_is_parallel=True,
            device=device, **tp_layer_kwargs(cfg))

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
        if self.cfg.context_axis is not None:
            # s is the LOCAL shard: attention over the global sequence
            from apex_tpu_torch.transformer.context_parallel import (
                ring_attention, ulysses_attention)
            attend = (ring_attention if self.cfg.context_mechanism == "ring"
                      else ulysses_attention)
            ctx = attend(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), self.cfg.context_axis,
                         causal=True)
            ctx = ctx.transpose(1, 2).reshape(b, s, nh * self.cfg.head_dim)
            out, _ = self.proj(ctx)
            return out, (k, v)
        rate = self.cfg.attention_dropout if dropout_seed is not None \
            else 0.0
        if rate > 0.0 and self.cfg.axis_name is not None:
            # the kernels' mask hashes the LOCAL (batch, head) index: without
            # an offset head j would draw the same mask on every rank
            rank = ps.group_rank(axis_group(self.cfg.axis_name))
            dropout_seed = wrap_int32(int(dropout_seed)
                                      + rank * _SEED_TP_RANK_STRIDE)
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

    def _qkv_at(self, x, positions, rope_cos, rope_sin):
        """``(q, k, v)`` of ``x`` ``(b, c, hidden)``, each ``(b, c,
        local_heads, head_dim)``, with RoPE at ``positions`` ``(b, c)``."""
        b, c = x.shape[:2]
        q, k, v = self._qkv(x)
        if rope_cos is not None:
            nh, hd = q.shape[2], self.cfg.head_dim
            flat = positions.reshape(-1)
            q = fused_apply_rotary_pos_emb_at_positions(
                q.reshape(b * c, nh, hd), rope_cos, rope_sin, flat
            ).reshape(b, c, nh, hd)
            k = fused_apply_rotary_pos_emb_at_positions(
                k.reshape(b * c, nh, hd), rope_cos, rope_sin, flat
            ).reshape(b, c, nh, hd)
        return q, k, v

    def decode_paged(self, x, pool, layer_index, block_tables, positions,
                     rope_cos=None, rope_sin=None):
        """One-token decode against a paged block pool: :meth:`decode` with
        the cache write and read indirected through ``block_tables``
        ``(b, max_blocks)``; ``pool``: ``(num_blocks, layers, 2,
        block_size, local_heads, head_dim)``, written IN PLACE.  Returns
        ``(out (b, 1, hidden), pool)``."""
        b = x.shape[0]
        bs = pool.shape[3]
        q, k, v = self._qkv_at(x, positions[:, None], rope_cos, rope_sin)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]       # (b, nh, hd)
        rows = torch.arange(b, device=x.device)
        bids = block_tables[rows, positions // bs]
        offs = positions % bs
        pool[bids, layer_index, 0, offs] = k.to(pool.dtype)
        pool[bids, layer_index, 1, offs] = v.to(pool.dtype)
        ctx = flash_attention_decode_paged(
            q, pool[:, layer_index, 0], pool[:, layer_index, 1],
            block_tables, positions + 1)
        out, _ = self.proj(ctx.reshape(b, 1, q.shape[1] * self.cfg.head_dim))
        return out, pool

    def decode_chunk(self, x, pool, layer_index, block_tables, positions,
                     write_blocks, write_offsets, rope_cos=None,
                     rope_sin=None):
        """Multi-token decode against the pool (chunked prefill /
        speculative verify): ``x`` ``(b, chunk, hidden)``; ``positions``,
        ``write_blocks``, ``write_offsets`` ``(b, chunk)``, the latter two
        the host's pool coordinates of each token's K/V (pad rows point at
        the garbage block 0).  Attends causally over the cached context up
        to each query's position."""
        b, c = x.shape[:2]
        q, k, v = self._qkv_at(x, positions, rope_cos, rope_sin)
        nh = q.shape[2]
        pool[write_blocks, layer_index, 0, write_offsets] = k.to(pool.dtype)
        pool[write_blocks, layer_index, 1, write_offsets] = v.to(pool.dtype)
        ctx = flash_attention_chunk_paged(
            q.transpose(1, 2), pool[:, layer_index, 0],
            pool[:, layer_index, 1], block_tables, positions)
        ctx = ctx.transpose(1, 2).reshape(b, c, nh * self.cfg.head_dim)
        out, _ = self.proj(ctx)
        return out, pool

    @staticmethod
    def _quant_insert(pool, scales, layer_index, bids, offs, k, v):
        """Write one token's K/V per row into an int8 pool: dequantize each
        row's target block, insert, and requantize the WHOLE block, in
        place.  Deterministic because quantized blocks are zeroed on
        allocation and a write target is never shared."""
        rows = torch.arange(bids.shape[0], device=bids.device)
        blk = pool[bids, layer_index]             # (b, 2, bs, nh, hd) int8
        sc = scales[bids, layer_index]            # (b, 2, nh) f32
        deq = blk.to(_f32) * sc[..., None, :, None]
        deq[rows, 0, offs] = k.to(_f32)
        deq[rows, 1, offs] = v.to(_f32)
        q8, new_sc = quantize_kv_blocks(deq)
        pool[bids, layer_index] = q8
        scales[bids, layer_index] = new_sc

    def decode_paged_quant(self, x, pool, scales, layer_index, block_tables,
                           positions, rope_cos=None, rope_sin=None):
        """:meth:`decode_paged` against an int8 scale-per-block pool
        (``scales``: ``(num_blocks, layers, 2, local_heads)`` f32): the
        written block is dequantized, updated and requantized; attention
        dequantizes the gathered blocks into its f32 scores.  Returns
        ``(out, pool, scales)``."""
        b = x.shape[0]
        bs = pool.shape[3]
        q, k, v = self._qkv_at(x, positions[:, None], rope_cos, rope_sin)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        bids = block_tables[torch.arange(b, device=x.device), positions // bs]
        self._quant_insert(pool, scales, layer_index, bids, positions % bs,
                           k, v)
        ctx = flash_attention_decode_paged_quant(
            q, pool[:, layer_index, 0], pool[:, layer_index, 1],
            scales[:, layer_index, 0], scales[:, layer_index, 1],
            block_tables, positions + 1)
        out, _ = self.proj(ctx.reshape(b, 1, q.shape[1] * self.cfg.head_dim))
        return out, pool, scales

    def decode_chunk_quant(self, x, pool, scales, layer_index, block_tables,
                           positions, write_blocks, write_offsets,
                           rope_cos=None, rope_sin=None):
        """:meth:`decode_chunk` against an int8 pool.  The chunk's tokens
        are inserted (their block requantized) one at a time, each
        attending right after its own insertion, under one shared QKV
        projection: the pool state is then a fold over per-token ops,
        independent of how the scheduler sliced the prompt."""
        b, c = x.shape[:2]
        q, k, v = self._qkv_at(x, positions, rope_cos, rope_sin)
        ctx = []
        for j in range(c):
            self._quant_insert(pool, scales, layer_index, write_blocks[:, j],
                               write_offsets[:, j], k[:, j], v[:, j])
            ctx.append(flash_attention_decode_paged_quant(
                q[:, j], pool[:, layer_index, 0], pool[:, layer_index, 1],
                scales[:, layer_index, 0], scales[:, layer_index, 1],
                block_tables, positions[:, j] + 1))
        ctx = torch.stack(ctx, dim=1)             # (b, c, nh, hd)
        out, _ = self.proj(ctx.reshape(b, c, -1))
        return out, pool, scales


class ParallelMLP(nn.Module):
    """Column → tanh-GELU → Row block (apex ParallelMLP): unfused, or with
    ``cfg.fused_ffn`` the fused op of :mod:`apex_tpu_torch.ops.fused_ffn`
    on the same ``fc1`` / ``fc2`` parameters."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fused_ffn = cfg.fused_ffn
        self.fc1 = tp.ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_hidden_size, gather_output=False,
            device=device, **tp_layer_kwargs(cfg))
        self.fc2 = tp.RowParallelLinear(
            cfg.ffn_hidden_size, cfg.hidden_size, input_is_parallel=True,
            device=device, **tp_layer_kwargs(cfg))

    def forward(self, x):
        if self.fused_ffn:
            return fused_ffn_tp_of(self.cfg, x, self.fc1, self.fc2)
        h, _ = self.fc1(x)
        y, _ = self.fc2(F.gelu(h, approximate="tanh"))
        return y


def fused_ffn_tp_of(cfg, x, fc1, fc2):
    """The fused FFN on the ``fc1`` / ``fc2`` layers' shards between their
    tensor- and sequence-parallel edges (:func:`~apex_tpu_torch.ops.
    fused_ffn.fused_ffn_tp`)."""
    return fused_ffn_tp(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                        tensor_parallel_size=cfg.tensor_parallel_size,
                        axis_name=cfg.axis_name,
                        sequence_parallel=cfg.sequence_parallel, seq_dim=1)


class MoEFFN(MoEMLP):
    """Switch / GShard FFN in the layer slot: flattens ``(b, s, h)`` to
    tokens for :class:`~apex_tpu_torch.transformer.expert_parallel.MoEMLP`
    and returns ``(y, aux_loss)``.  Its parameters are ``gate`` / ``w1`` /
    ``w2`` (the JAX ``mlp`` leaves)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__(MoEConfig(
            hidden_size=cfg.hidden_size, ffn_hidden_size=cfg.ffn_hidden_size,
            n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor,
            expert_parallel_size=cfg.expert_parallel_size,
            axis_name=cfg.expert_axis,
            tensor_parallel_size=cfg.tensor_parallel_size,
            tensor_axis=cfg.axis_name, param_dtype=cfg.param_dtype,
            compute_dtype=cfg.dtype), device)

    def forward(self, x):
        b, s, h = x.shape
        y, aux = super().forward(x.reshape(b * s, h))
        return y.reshape(b, s, h), aux


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer block (apex ParallelTransformerLayer); the FFN
    slot is dense (:class:`ParallelMLP`) or a mixture of experts
    (:class:`MoEFFN`, ``cfg.n_experts > 0``), whose ``forward`` then
    returns ``(x, aux)`` (the serving paths drop the aux).  Under sequence
    parallelism the two LayerNorms run on the sequence shard with their
    parameters wrapped by :func:`sp_param_map`."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_moe = cfg.n_experts > 0
        self.input_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                   device=device)
        self.attention = ParallelAttention(cfg, device)
        self.post_attention_layernorm = MixedFusedLayerNorm(cfg.hidden_size,
                                                            device=device)
        self.mlp = (MoEFFN(cfg, device) if self.is_moe
                    else ParallelMLP(cfg, device))

    def _ffn(self, h):
        """``(y, aux)`` of the FFN slot (aux None when dense)."""
        if self.is_moe:
            return self.mlp(h)
        return self.mlp(h), None

    def _block(self, x, rope_cos, rope_sin, dropout_seed):
        wrap = sp_param_map(self.cfg)
        attn, kv = self.attention.prefill(self.input_layernorm(x, wrap),
                                          rope_cos, rope_sin, dropout_seed)
        x = x + attn
        y, aux = self._ffn(self.post_attention_layernorm(x, wrap))
        return x + y, kv, aux

    def forward(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        x, _, aux = self._block(x, rope_cos, rope_sin, dropout_seed)
        return (x, aux) if self.is_moe else x

    def prefill(self, x, rope_cos=None, rope_sin=None, dropout_seed=None):
        """Returns ``(x_out, (k, v))`` with this layer's post-RoPE cache
        entries (a MoE aux is dropped: load balancing is a training
        concern)."""
        x, kv, _ = self._block(x, rope_cos, rope_sin, dropout_seed)
        return x, kv

    def _around(self, x, attend):
        """The block's residual / LN / MLP wiring around ``attend(ln(x))``,
        which returns ``(attn, *cache_state)``."""
        attn, *state = attend(self.input_layernorm(x))
        x = x + attn
        y, _ = self._ffn(self.post_attention_layernorm(x))
        return (x + y, *state)

    def decode(self, x, cache, layer_index, positions, rope_cos=None,
               rope_sin=None):
        return self._around(x, lambda h: self.attention.decode(
            h, cache, layer_index, positions, rope_cos, rope_sin))

    def decode_paged(self, x, pool, layer_index, block_tables, positions,
                     rope_cos=None, rope_sin=None):
        return self._around(x, lambda h: self.attention.decode_paged(
            h, pool, layer_index, block_tables, positions, rope_cos,
            rope_sin))

    def decode_chunk(self, x, pool, layer_index, block_tables, positions,
                     write_blocks, write_offsets, rope_cos=None,
                     rope_sin=None):
        return self._around(x, lambda h: self.attention.decode_chunk(
            h, pool, layer_index, block_tables, positions, write_blocks,
            write_offsets, rope_cos, rope_sin))

    def decode_paged_quant(self, x, pool, scales, layer_index, block_tables,
                           positions, rope_cos=None, rope_sin=None):
        return self._around(x, lambda h: self.attention.decode_paged_quant(
            h, pool, scales, layer_index, block_tables, positions, rope_cos,
            rope_sin))

    def decode_chunk_quant(self, x, pool, scales, layer_index, block_tables,
                           positions, write_blocks, write_offsets,
                           rope_cos=None, rope_sin=None):
        return self._around(x, lambda h: self.attention.decode_chunk_quant(
            h, pool, scales, layer_index, block_tables, positions,
            write_blocks, write_offsets, rope_cos, rope_sin))


class GPTModel(nn.Module):
    """Decoder LM: embedding → N layers → final LN → tied head (f32 logits
    for serving; the fused LM head or the f32 logits for the loss).

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent (pass
    ``device="cpu"`` for the plain PyTorch path).  Parameters start at the
    deterministic values of a fresh ``nn.Module`` (zero weights, unit LN
    gains); :meth:`init_params` draws the random weights from a
    :class:`torch.Generator`, or load a state dict (for instance one from
    :func:`apex_tpu_torch.convert.gpt_params_from_jax`).  Under tensor
    parallelism each rank builds its own shards (a ``model`` group of
    ``tensor_parallel_size`` ranks must exist when it runs), under expert
    parallelism its ``n_experts / expert_parallel_size`` experts.

    ``pipeline_stage=(n_stages, n_virtual, stage)`` builds pipeline rank
    ``stage``'s model for :func:`pipeline_step`: the embedding and final
    LayerNorm whole, and only the layers of its ``n_virtual`` chunks, chunk
    ``c`` being logical stage ``c * n_stages + stage``
    (:func:`pipeline_layer_ids`; ``layers.j`` is the ``j``-th of them).
    """

    def __init__(self, cfg: GPTConfig, device=None, pipeline_stage=None):
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
            cfg.vocab_size, cfg.hidden_size,
            world_size=cfg.tensor_parallel_size, axis_name=cfg.axis_name,
            param_dtype=cfg.param_dtype, device=dev)
        self.pipeline_stage = pipeline_stage
        self.layer_ids = (list(range(cfg.num_layers)) if pipeline_stage is None
                          else pipeline_layer_ids(cfg.num_layers,
                                                  *pipeline_stage))
        self.layers = nn.ModuleList(ParallelTransformerLayer(cfg, dev)
                                    for _ in self.layer_ids)
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
        they cannot replay ``jax.random``).  Each tensor-parallel rank
        draws the full weights and keeps its slices (an expert-parallel rank
        its experts, a pipeline stage its layers: the others' are drawn and
        dropped), so the shards are those of the serial model from the same
        seed.  A MoE slot draws the JAX init's scales: gate N(0, 0.02), w1
        N(0, 1/hidden), w2 N(0, 1/ffn)."""
        self.embedding.reset_parameters(generator)
        held = dict(zip(self.layer_ids, self.layers))
        cfg = self.cfg
        moe = cfg.n_experts > 0
        expert_rank = (ps.group_rank(ps.resolve_group(cfg.expert_axis))
                       if moe and cfg.expert_axis is not None else 0)
        tensor_rank = (ps.group_rank(axis_group(cfg.axis_name))
                       if moe and cfg.axis_name is not None else 0)
        for i in range(self.cfg.num_layers):
            layer = held.get(i)
            if layer is None:       # drawn and dropped, to keep the stream
                layer = ParallelTransformerLayer(self.cfg, "meta")
            for lin in (layer.attention.qkv, layer.attention.proj):
                lin.reset_parameters(generator)
            if layer.is_moe:
                layer.mlp.reset_parameters(generator, expert_rank,
                                           tensor_rank)
            else:
                layer.mlp.fc1.reset_parameters(generator)
                layer.mlp.fc2.reset_parameters(generator)
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

    def _context(self):
        """``(size, rank)`` of the context group (``(1, 0)`` without
        context parallelism)."""
        if self.cfg.context_axis is None:
            return 1, 0
        group = ps.resolve_group(self.cfg.context_axis)
        return ps.group_size(group), ps.group_rank(group)

    def _seq_offset(self, local_len):
        """Global position of this shard's first token (0 without context
        parallelism)."""
        return self._context()[1] * local_len

    def embed(self, tokens):
        x = self.embedding(tokens)
        if not self.cfg.rotary:
            off = self._seq_offset(tokens.shape[1])
            x = x + self.position_embedding[off:off + tokens.shape[1]]
        return x.to(self.cfg.dtype)

    def _head_logits(self, x):
        """Tied-embedding head GEMM in full f32; on an int8 embedding the
        dequant-GEMM on f32 ``x``."""
        emb = self.embedding
        if emb.weight_scale is not None:
            return quant_gemm(x.to(_f32), emb.weight, emb.weight_scale)
        return torch.matmul(x.to(_f32), emb.weight.to(_f32).t())

    def logits(self, x):
        """Final LN + tied head: ``(b, s, vocab / t)`` f32 (this rank's
        vocab shard under tensor parallelism).  Outside sequence
        parallelism the f32 head input is copied into the tensor-parallel
        region (all-reduce backward: each rank's head sees its vocab shard
        only), under it the final LayerNorm's parameters are wrapped
        (:func:`sp_param_map`) and the gather before the head sums the
        input's gradient."""
        h = self.final_layernorm(x, sp_param_map(self.cfg))
        if self.cfg.axis_name is not None and not self.cfg.sequence_parallel:
            h = tp.copy_to_tensor_model_parallel_region(
                h.to(_f32), self.cfg.axis_name)
        return self._head_logits(h)

    def _check_whole(self):
        if self.pipeline_stage is not None and self.pipeline_stage[0] > 1:
            raise ValueError(
                "this model holds one pipeline stage's layers: run it "
                "through pipeline_step")

    def backbone(self, x, dropout_seed=None, seq_len=None):
        """The layers over embedded ``x`` ``(b, s, hidden)`` (``(b, s / t,
        hidden)`` under sequence parallelism, with ``seq_len`` the whole
        sequence's length for the RoPE tables; under context parallelism
        the local shard, whose RoPE rows start at its global offset).  With
        a ``dropout_seed``, layer ``i`` drops attention probabilities with
        the stream ``dropout_seed + i * _SEED_LAYER_STRIDE``."""
        return self.backbone_aux(x, dropout_seed, seq_len)[0]

    def backbone_aux(self, x, dropout_seed=None, seq_len=None):
        """:meth:`backbone` and the layers' summed MoE aux loss (an f32
        scalar; 0 for dense FFNs)."""
        self._check_whole()
        local = seq_len or x.shape[1]
        n_ctx, _ = self._context()
        cos, sin = self.rope_tables(local * n_ctx)
        if cos is not None and n_ctx > 1:
            off = self._seq_offset(local)
            cos, sin = cos[off:off + local], sin[off:off + local]
        aux_total = torch.zeros((), dtype=_f32, device=x.device)
        for li, layer in enumerate(self.layers):
            seed = (None if dropout_seed is None
                    else int(dropout_seed) + li * _SEED_LAYER_STRIDE)
            out = remat_call(self.cfg, layer, x, cos, sin, seed)
            if layer.is_moe:
                x, aux = out
                aux_total = aux_total + aux
            else:
                x = out
        return x, aux_total

    def head_loss(self, x, targets):
        """Per-token cross entropy ``(b, s)`` f32 of the tied head on
        backbone output ``x``.

        With ``cfg.fused_lm_head`` (the default): final LN, then
        :func:`~apex_tpu_torch.ops.lm_head.fused_linear_cross_entropy` on
        operands at the compute dtype (the kernels dot at operand precision
        with f32 accumulation; the ``(b*s, vocab)`` logits never exist).
        The ``.to`` of the f32 tied weight is differentiable, so the
        kernel's bf16 dW flows into the f32 embedding's gradient.  At an f32
        ``cfg.dtype`` (the config's default) the kernels run on the FMA
        units, about twice the time of the f32 head GEMMs and cross
        entropy on an H100 (PERF.md): an f32 model trains faster on the
        card with ``fused_lm_head=False``.  Else the f32 head GEMM, then
        :func:`~apex_tpu_torch.transformer.tensor_parallel.
        vocab_parallel_cross_entropy`; under tensor parallelism always the
        latter (vocab-parallel logits), as in JAX."""
        if self.cfg.weight_quant is not None:
            raise ValueError(
                f"weight_quant={self.cfg.weight_quant!r} is a decode/prefill-"
                "only knob: the loss builds gradients, and int8 weights "
                "have none — train with weight_quant=None and let the "
                "inference engine quantize at init (quantize_decode_params)")
        b, s = targets.shape
        if self.cfg.axis_name is None and self.cfg.fused_lm_head:
            h = self.final_layernorm(x)
            return fused_linear_cross_entropy(
                h.reshape(b * s, h.shape[-1]).to(self.cfg.dtype),
                self.embedding.weight.to(self.cfg.dtype),
                targets.reshape(b * s)).reshape(b, s)
        logits = self.logits(x)
        return tp.vocab_parallel_cross_entropy(
            logits.reshape(b * s, logits.shape[-1]),
            targets.reshape(b * s),
            axis_name=self.cfg.axis_name).reshape(b, s)

    def _sp_enabled(self):
        return self.cfg.sequence_parallel and self.cfg.axis_name is not None

    def _sp_scatter(self, x):
        """The sequence-parallel entry edge: this rank's shard of the
        sequence (all-gather backward)."""
        if x.shape[1] % self.cfg.tensor_parallel_size:
            raise ValueError(
                f"sequence_parallel requires seq_len divisible by "
                f"tensor_parallel_size ({x.shape[1]} % "
                f"{self.cfg.tensor_parallel_size} != 0)")
        return tp.scatter_to_sequence_parallel_region(x, self.cfg.axis_name,
                                                      1)

    def _sp_gather(self, x):
        """The exit edge before the vocab-parallel head; its backward
        reduce-scatters, summing the ranks' vocab-shard contributions."""
        return tp.gather_from_sequence_parallel_region(x, self.cfg.axis_name,
                                                       1)

    def hidden(self, tokens, dropout_seed=None):
        """Embedding and layers: the backbone output ``(b, s, hidden)``,
        scattered over the sequence after the embedding and gathered again
        under sequence parallelism."""
        return self._hidden_aux(tokens, dropout_seed)[0]

    def _hidden_aux(self, tokens, dropout_seed=None):
        x = self.embed(tokens)
        if self._sp_enabled():
            x = self._sp_scatter(x)
        x, aux = self.backbone_aux(x, dropout_seed, seq_len=tokens.shape[1])
        return (self._sp_gather(x) if self._sp_enabled() else x), aux

    def loss(self, tokens, targets, dropout_seed=None):
        """Mean next-token loss (f32 scalar) of ``tokens (b, s)`` against
        ``targets (b, s)``; differentiable in every parameter.  With MoE
        FFNs it adds ``moe_aux_weight * aux / num_layers`` (the Switch
        load-balancing term).  ``dropout_seed`` (int) enables
        ``cfg.attention_dropout`` for this step (advance it by +1 per
        step); ``None`` means no dropout.

        Under context parallelism ``tokens`` / ``targets`` are this rank's
        sequence shard and the local mean is averaged over the context
        group (JAX's ``pmean``; its backward hands each rank ``1 / n`` of
        the cotangent): each rank's parameter gradients are then its
        partial sums, whose sum over the group
        (:func:`apex_tpu_torch.utils.collectives.psum_if_varying`) is the
        whole batch's gradient, as in JAX."""
        x, aux = self._hidden_aux(tokens, dropout_seed)
        mean = torch.mean(self.head_loss(x, targets))
        if self.cfg.n_experts > 0:
            self.moe_aux = aux.detach()     # the last call's, for logging
            mean = mean + self.cfg.moe_aux_weight * aux / self.cfg.num_layers
        if self.cfg.context_axis is not None:
            mean = context_mean(mean, self.cfg.context_axis)
        return mean

    def forward(self, tokens, dropout_seed=None):
        """Full causal forward: ``tokens (b, s)`` → logits ``(b, s, vocab /
        t)`` f32; differentiable."""
        return self.logits(self.hidden(tokens, dropout_seed))

    def _check_decode_supported(self):
        self._check_whole()
        if self.cfg.context_axis is not None:
            raise ValueError(
                "KV-cache decode does not compose with context "
                "parallelism (the cache would be sequence-sharded)")
        if self.cfg.sequence_parallel:
            raise ValueError(
                "KV-cache decode requires sequence_parallel=False "
                "(decode steps are single-token)")

    @torch.no_grad()
    def prefill(self, tokens):
        """Process a full prompt; returns ``(logits, kv)``.

        ``logits``: ``(b, s, vocab)`` f32; ``kv``: ``(layers, 2, b, s,
        local_heads, head_dim)`` post-RoPE cache entries in the compute
        dtype, for :meth:`apex_tpu_torch.inference.KVCache.write_prompt`.
        Prompts padded beyond their true length are safe: causal masking
        keeps the logits at positions ``< prompt_len`` unaffected.
        """
        self._check_decode_supported()
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
        self._check_decode_supported()
        x = self._embed_at(tokens[:, None], positions[:, None])
        cos, sin = self.rope_tables(cache.shape[3])
        for li, layer in enumerate(self.layers):
            x, cache = layer.decode(x, cache, li, positions, cos, sin)
        x = self.final_layernorm(x)
        return self._head_logits(x[:, 0]), cache

    def _embed_at(self, tokens, positions):
        """Embedded ``tokens`` ``(b, c)`` at absolute ``positions`` ``(b,
        c)``, in the compute dtype."""
        x = self.embedding(tokens)
        if not self.cfg.rotary:
            x = x + self.position_embedding[positions]
        return x.to(self.cfg.dtype)

    def _pool_rope(self, block_tables, pool):
        """RoPE tables at the pool's logical depth ``max_blocks *
        block_size``; their rows are those of any other depth, so paged and
        contiguous decode rotate identically."""
        return self.rope_tables(block_tables.shape[1] * pool.shape[3])

    @torch.no_grad()
    def decode_step_paged(self, tokens, pool, block_tables, positions):
        """One batched decode step against a paged block pool.

        :meth:`decode_step` op for op (same embed, RoPE rows and f32 head)
        with the cache access indirected through ``block_tables`` ``(slots,
        max_blocks)`` int32 (see :class:`apex_tpu_torch.serving.
        PagedKVCache`); ``pool`` is updated in place.  Rows whose table is
        all garbage (block 0) compute garbage that is never read.  Returns
        ``(logits (slots, vocab) f32, pool)``.
        """
        self._check_decode_supported()
        x = self._embed_at(tokens[:, None], positions[:, None])
        cos, sin = self._pool_rope(block_tables, pool)
        for li, layer in enumerate(self.layers):
            x, pool = layer.decode_paged(x, pool, li, block_tables,
                                         positions, cos, sin)
        x = self.final_layernorm(x)
        return self._head_logits(x[:, 0]), pool

    @torch.no_grad()
    def decode_chunk(self, tokens, pool, block_tables, positions,
                     write_blocks, write_offsets):
        """``chunk`` tokens per sequence against the paged pool in one
        forward: chunked prefill and speculative verification.

        ``tokens`` / ``positions`` / ``write_blocks`` / ``write_offsets``:
        ``(slots, chunk)``.  Returns ``(logits (slots, chunk, vocab),
        pool)`` through the same head as :meth:`prefill`.
        """
        self._check_decode_supported()
        x = self._embed_at(tokens, positions)
        cos, sin = self._pool_rope(block_tables, pool)
        for li, layer in enumerate(self.layers):
            x, pool = layer.decode_chunk(x, pool, li, block_tables,
                                         positions, write_blocks,
                                         write_offsets, cos, sin)
        return self.logits(x), pool

    @torch.no_grad()
    def decode_step_paged_quant(self, tokens, pool, scales, block_tables,
                                positions):
        """:meth:`decode_step_paged` against an int8 scale-per-block pool
        (``pool`` int8, ``scales`` ``(num_blocks, layers, 2, local_heads)``
        f32; see :class:`apex_tpu_torch.serving.QuantizedPagedKVCache`).
        Returns ``(logits, pool, scales)``."""
        self._check_decode_supported()
        x = self._embed_at(tokens[:, None], positions[:, None])
        cos, sin = self._pool_rope(block_tables, pool)
        for li, layer in enumerate(self.layers):
            x, pool, scales = layer.decode_paged_quant(
                x, pool, scales, li, block_tables, positions, cos, sin)
        x = self.final_layernorm(x)
        return self._head_logits(x[:, 0]), pool, scales

    @torch.no_grad()
    def decode_chunk_quant(self, tokens, pool, scales, block_tables,
                           positions, write_blocks, write_offsets):
        """:meth:`decode_chunk` against an int8 pool, each layer inserting
        the chunk's tokens one at a time (see
        :meth:`ParallelAttention.decode_chunk_quant`).  Returns ``(logits,
        pool, scales)``."""
        self._check_decode_supported()
        x = self._embed_at(tokens, positions)
        cos, sin = self._pool_rope(block_tables, pool)
        for li, layer in enumerate(self.layers):
            x, pool, scales = layer.decode_chunk_quant(
                x, pool, scales, li, block_tables, positions, write_blocks,
                write_offsets, cos, sin)
        return self.logits(x), pool, scales

    # -- int8 decode weights -------------------------------------------------

    def _quant_modules(self):
        """``(state-dict prefix, module)`` of every layer whose weight
        ``weight_quant="int8"`` quantizes."""
        yield "embedding", self.embedding
        for i, layer in enumerate(self.layers):
            for name in ("attention.qkv", "attention.proj", "mlp.fc1",
                         "mlp.fc2"):
                yield f"layers.{i}.{name}", layer.get_submodule(name)

    @property
    def quantized(self) -> bool:
        """True once :meth:`load_quantized_` installed int8 weights."""
        return self.embedding.weight_scale is not None

    def load_quantized_(self, state_dict) -> "GPTModel":
        """Install an int8 state dict (:func:`quantize_decode_params` of
        this model's, or :func:`apex_tpu_torch.convert.
        gpt_quant_params_from_jax`) in place: each quantized layer's
        ``weight`` becomes an int8 buffer beside its f32 ``weight_scale``,
        and every other entry loads as usual.  Needs
        ``cfg.weight_quant == "int8"``."""
        if self.cfg.weight_quant != "int8":
            raise ValueError("load_quantized_ needs a model built with "
                             "GPTConfig(weight_quant='int8')")
        for prefix, module in self._quant_modules():
            if module.weight_scale is None:
                install_int8_weight(module, state_dict[prefix + ".weight"],
                                    state_dict[prefix + ".weight_scale"])
        self.load_state_dict(state_dict)
        return self


_QUANTIZED = re.compile(
    r"(embedding|layers\.\d+\.(attention\.(qkv|proj)|mlp\.(fc1|fc2)))"
    r"\.weight")


def quantize_decode_params(state_dict) -> dict:
    """Quantize a :class:`GPTModel` state dict for the int8 decode path
    (``GPTConfig(weight_quant="int8")``), once, at engine init.

    ``embedding.weight`` (the gather and the tied head) and each layer's
    ``qkv`` / ``proj`` / ``fc1`` / ``fc2`` weight become int8 with an f32
    ``<name>.weight_scale`` per output row (:func:`apex_tpu_torch.ops.
    quant_gemm.quantize_weight`); biases, LayerNorms and the position
    embedding stay as they are.  Install the result with
    :meth:`GPTModel.load_quantized_`.
    """
    out = {}
    for name, t in state_dict.items():
        if name.endswith(".weight_scale"):
            raise ValueError(f"{name}: the state dict is already quantized")
        if name.endswith("mlp.gate"):
            raise ValueError(
                "quantize_decode_params covers dense GPT state dicts; this "
                "one has MoE expert stacks (mlp.gate) — "
                "GPTConfig(weight_quant=...) rejects n_experts > 0 for the "
                "same reason")
        if _QUANTIZED.fullmatch(name):
            w8, scale = quantize_weight(t)
            out[name] = w8
            out[name + "_scale"] = scale
        else:
            out[name] = t
    return out


_COLUMN_SHARDED = re.compile(
    r"(embedding|layers\.\d+\.(attention\.qkv|mlp\.fc1))"
    r"\.(weight|bias|weight_scale)")
_ROW_SHARDED = re.compile(r"layers\.\d+\.(attention\.proj|mlp\.fc2)\.weight")
_MOE_LEAF = re.compile(r"layers\.\d+\.mlp\.(w1|w2)")


def shard_params_for_tp(cfg, state_dict, rank: int) -> dict:
    """Rank ``rank``'s tensor-parallel state dict cut from a serial
    :class:`GPTModel` state dict (the JAX ``shard_params_for_tp``): the
    column layers' (qkv, fc1) and the vocab embedding's weight, bias and
    int8 scale rows, the row layers' (proj, fc2) weight columns; their
    biases and per-output-row scales, the LayerNorms and the position
    embedding whole; a MoE slot's ``w1`` along its FFN dim (dim 2) and
    ``w2`` along dim 1, its gate whole.  A column layer's scales are the
    slice of the full
    weight's, so quantizing then sharding equals sharding then quantizing
    there bit for bit; a row shard quantized alone has its own, tighter
    scales.  Works on any ``cfg`` with the model's names (BERT's column /
    row layers have their own names: :func:`apex_tpu_torch.models.bert.
    shard_params_for_tp`)."""
    t = cfg.tensor_parallel_size
    out = shard_state_dict(state_dict, rank, t, _COLUMN_SHARDED,
                           _ROW_SHARDED)
    for name, v in state_dict.items():
        dim = {"w1": 2, "w2": 1}.get(name.rsplit(".", 1)[-1]) \
            if _MOE_LEAF.fullmatch(name) else None
        if dim is not None:
            per = v.shape[dim] // t
            out[name] = v.narrow(dim, rank * per, per).contiguous()
    return out


def shard_state_dict(state_dict, rank, t, column, row) -> dict:
    """``state_dict`` with the names that ``column`` matches cut to their
    ``rank``-th block of rows out of ``t`` and those that ``row`` matches
    to their block of columns; every other entry as it is."""
    out = {}
    for name, v in state_dict.items():
        if column.fullmatch(name):
            per = v.shape[0] // t
            out[name] = v[rank * per:(rank + 1) * per].contiguous()
        elif row.fullmatch(name):
            per = v.shape[1] // t
            out[name] = v[:, rank * per:(rank + 1) * per].contiguous()
        else:
            out[name] = v
    return out


def _reset_layer_norm(ln) -> None:
    with torch.no_grad():
        ln.weight.fill_(1.0)
        if ln.bias is not None:
            ln.bias.zero_()


class _ContextMean(torch.autograd.Function):
    """The mean over the context group (JAX ``pmean``): forward the
    all-reduced sum over ``n``; backward ``1 / n`` of the cotangent, as
    JAX transposes a ``pmean`` of a varying value."""

    @staticmethod
    def forward(ctx, x, group):
        n = ps.group_size(group)
        ctx.n = n
        out = x.detach().clone()
        torch.distributed.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def context_mean(x, axis_name):
    """Mean of ``x`` over the ``axis_name`` group (identity at one
    rank)."""
    group = axis_group(axis_name)
    if group is None:
        return x
    return _ContextMean.apply(x, group)


# -- pipeline composition ----------------------------------------------------
#
# The JAX package packs the whole parameter tree for one ``shard_map``
# (``pack_for_shard_map`` / ``unpack_from_shard_map``: GSPMD bookkeeping
# with no counterpart here).  Each pipeline rank of the port builds its own
# model (``GPTModel(cfg, pipeline_stage=(n_stages, n_virtual, stage))``)
# and loads its own state dict (:func:`stage_state_dict`,
# ``convert.gpt_params_from_jax(..., pipeline_stage=...)``).

def stack_layers_for_pipeline(layer_params, n_stages: int,
                              n_virtual: int = 1):
    """Split the per-layer ``layer_params`` (any sequence, one item a
    layer) into pipeline stages as the JAX function stacks them: with
    ``n_virtual == 1`` a list of ``n_stages`` lists of contiguous layers;
    otherwise ``n_stages`` lists of ``n_virtual`` chunks, device ``s``
    chunk ``c`` holding logical stage ``c * n_stages + s`` (Megatron's
    interleaved assignment)."""
    n_layers = len(layer_params)
    n_logical = n_stages * n_virtual
    if n_layers % n_logical:
        raise ValueError(
            f"num_layers ({n_layers}) must be divisible by the number of "
            f"logical pipeline stages ({n_stages} x {n_virtual})")
    lpc = n_layers // n_logical
    logical = [list(layer_params[i * lpc:(i + 1) * lpc])
               for i in range(n_logical)]
    if n_virtual == 1:
        return logical
    return [[logical[c * n_stages + s] for c in range(n_virtual)]
            for s in range(n_stages)]


def pipeline_layer_ids(num_layers: int, n_stages: int, n_virtual: int,
                       stage: int):
    """The global layer indices of pipeline rank ``stage``, chunk by chunk
    (:func:`stack_layers_for_pipeline`'s assignment)."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} is not in [0, {n_stages})")
    stacks = stack_layers_for_pipeline(list(range(num_layers)), n_stages,
                                       n_virtual)[stage]
    if n_virtual == 1:
        return list(stacks)
    return [i for chunk in stacks for i in chunk]


_LAYER_NAME = re.compile(r"layers\.(\d+)\.(.*)")


def stage_state_dict(state_dict, num_layers: int, n_stages: int,
                     n_virtual: int, stage: int) -> dict:
    """Pipeline rank ``stage``'s state dict cut from a whole model's: its
    layers renumbered in its chunk order, the embedding, final LayerNorm
    (and position embedding) whole."""
    local = {g: j for j, g in enumerate(
        pipeline_layer_ids(num_layers, n_stages, n_virtual, stage))}
    out = {}
    for name, v in state_dict.items():
        m = _LAYER_NAME.fullmatch(name)
        if m is None:
            out[name] = v
        elif int(m.group(1)) in local:
            out[f"layers.{local[int(m.group(1))]}.{m.group(2)}"] = v
    return out


def make_stage_fn(model: GPTModel, dropout_seed=None,
                  remat: Optional[bool] = None):
    """The ring engine's ``stage_fn(chunk_layers, carry, info)``: this
    chunk's layers over the activation ``(mb, s, h)`` (or, for MoE models,
    ``(x, aux)``, each logical stage adding its layers' aux losses so the
    last stage holds the micro-batch's total; the tuple rides the ring).

    ``dropout_seed`` enables attention dropout with the per-layer stream
    derived from the job: layer ``j`` of logical stage ``info.stage`` on
    micro-batch ``info.microbatch`` draws ``base + m * MB_STRIDE + (stage *
    lpc + j) * LAYER_STRIDE`` (int32, wrapping), as in JAX.  ``remat``
    (default ``cfg.remat``) runs each layer under :func:`remat_call`."""
    cfg = model.cfg
    moe = cfg.n_experts > 0
    remat_cfg = types.SimpleNamespace(
        remat=cfg.remat if remat is None else bool(remat),
        remat_policy=cfg.remat_policy)

    def stage_fn(chunk_layers, carry, info):
        x, aux = carry if moe else (carry, None)
        # under SP the carry is the sequence shard; RoPE rows are global
        seq = x.shape[1]
        if model._sp_enabled():
            seq = seq * cfg.tensor_parallel_size
        cos, sin = model.rope_tables(seq)
        seed = None
        if dropout_seed is not None:
            seed = wrap_int32(int(dropout_seed)
                              + int(info.microbatch) * _SEED_MB_STRIDE
                              + int(info.stage) * len(chunk_layers)
                              * _SEED_LAYER_STRIDE)
        for layer in chunk_layers:
            out = remat_call(remat_cfg, layer, x, cos, sin, seed)
            if moe:
                x, la = out
                aux = aux + la.to(aux.dtype)
            else:
                x = out
            if seed is not None:
                seed = wrap_int32(seed + _SEED_LAYER_STRIDE)
        return (x, aux) if moe else x

    return stage_fn


def pipeline_step(model: GPTModel, tokens, targets, *,
                  pipe_axis: str = ps.PIPELINE_AXIS,
                  data_axis: Optional[str] = None, n_virtual: int = 1,
                  remat: Optional[bool] = None, dropout_seed=None):
    """GPT training step (loss and gradients) over the ring pipeline
    engine (:func:`~apex_tpu_torch.transformer.pipeline_parallel.
    pipeline_schedule_step`): ``model`` is this pipe rank's stage model
    (``GPTModel(cfg, pipeline_stage=(S, n_virtual, rank))``), ``tokens`` /
    ``targets`` ``(M, mb, s)`` micro-batches (the same on every pipe rank).
    Adds the step's gradients to every parameter's ``.grad`` and returns
    the mean loss (a detached f32 scalar).

    The embedding runs once outside the engine (all micro-batches
    flattened); its pullback consumes the engine's ``dx0`` (summed over the
    pipe group: only rank 0 has it), and the tied embedding's gradient is
    that pullback plus the last stage's head contribution (summed over
    the pipe group), as in JAX.  Dropout seeds come from the logical stage
    and the micro-batch, never the rank.  A MoE model's aux rides with the
    activation.  ``data_axis`` averages loss and gradients over that group;
    an ``expert_axis`` applies :func:`~apex_tpu_torch.transformer.
    expert_parallel.reduce_moe_grads` (and the loss mean).

    Tensor parallelism inside the pipeline requires
    ``sequence_parallel=True`` (as in JAX); ``weight_quant`` is refused."""
    from apex_tpu_torch.transformer.expert_parallel import (
        is_gpt_expert_leaf)
    from apex_tpu_torch.transformer.pipeline_parallel.ring import (
        pipeline_schedule_step)
    from apex_tpu_torch.utils.collectives import all_reduce_

    cfg = model.cfg
    if cfg.weight_quant is not None:
        raise ValueError(
            f"weight_quant={cfg.weight_quant!r} is a decode/prefill-only "
            "knob: pipeline_step builds gradients, and int8 weights have "
            "none — train with weight_quant=None and let the inference "
            "engine quantize at init (quantize_decode_params)")
    if cfg.axis_name is not None and not cfg.sequence_parallel:
        raise ValueError(
            "pipeline_step under tensor parallelism requires "
            "sequence_parallel=True (non-SP TP grads need shard_map's "
            "auto-psum, which the hand-rolled pipeline backward bypasses)")
    group = ps.resolve_group(pipe_axis)
    n_stages = ps.group_size(group)
    want = (n_stages, int(n_virtual), ps.group_rank(group))
    have = model.pipeline_stage or (1, 1, 0)
    if n_stages > 1 and tuple(have) != want:
        raise ValueError(
            f"pipeline_step over {n_stages} stages with n_virtual="
            f"{n_virtual} on rank {want[2]} needs the model of that stage "
            f"(GPTModel(cfg, pipeline_stage={want})); it was built with "
            f"{model.pipeline_stage}")
    moe = cfg.n_experts > 0
    n_mb, mb, seq = tokens.shape
    with_seed = cfg.attention_dropout > 0.0 and dropout_seed is not None

    # ---- embedding: one flattened-batch pass outside the engine ---------
    embed_params = [model.embedding.weight] + (
        [] if cfg.rotary else [model.position_embedding])
    x_all = model.embed(tokens.reshape(n_mb * mb, seq))
    if model._sp_enabled():
        x_all = model._sp_scatter(x_all)
    x_all = x_all.reshape((n_mb, mb) + tuple(x_all.shape[1:]))
    x0 = x_all.detach()
    if moe:
        x0 = (x0, torch.zeros((n_mb,), dtype=_f32, device=x0.device))

    # ---- last stage: final LN + tied head + CE --------------------------
    last_params = list(model.final_layernorm.parameters()) + [
        model.embedding.weight]

    def last_fn(_, y, tgt, info):
        aux = None
        if moe:
            y, aux = y
        if model._sp_enabled():
            y = model._sp_gather(y)
        lm = torch.mean(model.head_loss(y, tgt))
        if moe:
            lm = lm + cfg.moe_aux_weight * aux / cfg.num_layers
        return lm

    lpc = len(model.layers) // int(n_virtual)
    chunks = [model.layers[c * lpc:(c + 1) * lpc]
              for c in range(int(n_virtual))]
    loss, layer_grads, last_grads, dx0 = pipeline_schedule_step(
        make_stage_fn(model, dropout_seed if with_seed else None,
                      remat=remat),
        last_fn, chunks if n_virtual > 1 else chunks[0], last_params, x0,
        targets, axis_name=pipe_axis, n_virtual=n_virtual)

    # ---- embedding pullback (dx0 is summed over the pipe group) ---------
    dx = dx0[0] if moe else dx0
    embed_grads = torch.autograd.grad(x_all, embed_params, dx,
                                      allow_unused=True)
    grads = {id(p): g for p, g in zip(embed_params, embed_grads)}
    for p, g in zip(last_params, last_grads):
        grads[id(p)] = g if id(p) not in grads else grads[id(p)] + g
    chunk_grads = layer_grads if n_virtual > 1 else [layer_grads]
    for chunk, gs in zip(chunks, chunk_grads):
        for p, g in zip(chunk.parameters(), gs):
            grads[id(p)] = g
    by_param = [(name, p, grads.get(id(p)))
                for name, p in model.named_parameters()]
    reductions = []
    if data_axis is not None:
        reductions.append((ps.resolve_group(data_axis), False))
    if moe and cfg.expert_axis is not None:
        # the expert axis doubles as a batch axis for the dense compute:
        # dense leaves average over it, expert stacks (per-shard sums of
        # the whole batch) divide by its size (reduce_moe_grads)
        reductions.append((ps.resolve_group(cfg.expert_axis), True))
    for rgroup, experts in reductions:
        n = ps.group_size(rgroup)
        if n == 1:
            continue
        all_reduce_(loss, rgroup).div_(n)
        for name, p, g in by_param:
            if g is None:
                continue
            if not (experts and is_gpt_expert_leaf(name)):
                all_reduce_(g, rgroup)
            g.div_(n)
    for _, p, g in by_param:
        if g is None:
            continue
        if p.grad is None:
            p.grad = g.to(p.dtype)
        else:
            p.grad.add_(g)
    return loss
