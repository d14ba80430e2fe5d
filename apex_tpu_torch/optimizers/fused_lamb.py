"""FusedLAMB — port of ``apex_tpu/optimizers/fused_lamb.py`` (the per-leaf
layout).

apex's two-phase design: phase 1 is the global L2 norm of every gradient of
every group (one :func:`~apex_tpu_torch.ops.multi_tensor.
multi_tensor_sumsq` launch set, kernel #17), folded into a clip factor
``where(norm > max_grad_norm, max_grad_norm / norm, 1)`` on the device;
phase 2 is, per group, LAMB stage 1 (moments, the raw update u into an f32
scratch the optimizer keeps, per-chunk sums of u^2 and p^2; kernel #20) and
stage 2 (each tensor's trust ratio from its partials, then p -= lr * ratio
* u, and under master weights the model's copy in the same pass; kernel
#21).  The JAX per-leaf step runs the same ``_lamb_stage1_math`` per leaf
and leaves its fusion to XLA; eager PyTorch needs the kernels.

apex semantics: ``adam_w_mode`` (decoupled decay, default) or L2 in the
gradient; ``grad_averaging`` (beta3 = 1 - beta1, else 1); ``use_nvlamb``
applies the trust ratio where the parameter's norm is zero; ``amsgrad``
raises.  Moments ``exp_avg`` / ``exp_avg_sq`` are f32 per parameter.

The packed bucket form (:meth:`FusedLAMB._update_bucket`, what the ZeRO
:class:`~apex_tpu_torch.parallel.distributed_optimizer.
DistributedFusedLAMB` runs on a rank's shard of each bucket; JAX
``fused_lamb.py:44-88`` and ``distributed_optimizer.py:382-438``) runs the
same kernels over the shard's segments (each tensor's rows in the shard,
one view each): the global norm from #17 over the gradient segments, its
sum across the ranks; stage 1 (#20) on the segments; each tensor's sums
of u^2 and p^2 from its segments' chunk partials, summed across the ranks
(a tensor may straddle shards); then stage 2 (#21) on partials that hold
each tensor's total in its segment's first chunk and zeros elsewhere, so
the kernel's per-tensor sum is that total exactly.
"""

from __future__ import annotations

import torch

import numpy as np

from apex_tpu_torch.multi_tensor_apply.bucketing import (DEFAULT_BLOCK_ROWS,
                                                        segment_views)
from apex_tpu_torch.ops.multi_tensor import (chunk_counts, device_scalars,
                                             multi_tensor_lamb_stage1,
                                             multi_tensor_lamb_stage2,
                                             multi_tensor_sumsq)
from apex_tpu_torch.optimizers.base import FusedOptimizer

_f32 = torch.float32


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 master_weights=False, bucketed=None, message_size=None,
                 block_rows=DEFAULT_BLOCK_ROWS):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")  # apex parity
        self.set_grad_none = bool(set_grad_none)
        self.max_grad_norm = max_grad_norm
        self._updates = {}     # parameter (or bucket key) -> f32 scratch
        self._chunk_maps = {}  # bucket key -> (tensor of each chunk, ...)
        super().__init__(params, dict(
            lr=lr, bias_correction=bool(bias_correction),
            betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            adam_w_mode=bool(adam_w_mode),
            grad_averaging=bool(grad_averaging),
            use_nvlamb=bool(use_nvlamb)), master_weights=master_weights,
            bucketed=bucketed, message_size=message_size,
            block_rows=block_rows)

    def zero_grad(self, set_to_none=None):
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p, dtype=_f32)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=_f32)

    def _pre_step(self, grads, grad_scale):
        # phase 1: the global norm of the raw gradients of every leaf
        total, _, _ = multi_tensor_sumsq(grads)
        return self._clip_factor(total, grad_scale)

    def _clip_factor(self, total, grad_scale):
        norm = torch.sqrt(total) * grad_scale
        max_norm = float(self.max_grad_norm)
        return torch.where(norm > max_norm, max_norm / norm,
                           torch.ones_like(norm))

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, clip):
        beta1, beta2 = group["betas"]
        bc1, bc2 = self._bias_corrections(group, step_count)
        beta3 = 1.0 - beta1 if group["grad_averaging"] else 1.0
        device = targets[0].device
        scal = device_scalars((beta1, beta2, group["eps"],
                               group["weight_decay"], bc1, bc2, grad_scale,
                               clip, beta3), device)
        states = [self.state[p] for p in params]
        updates = []
        for p in params:
            if p not in self._updates:   # allocated once, reused every step
                self._updates[p] = torch.empty(p.shape, dtype=_f32,
                                               device=device)
            updates.append(self._updates[p])
        u_sq, p_sq = multi_tensor_lamb_stage1(
            grads, targets, [st["exp_avg"] for st in states],
            [st["exp_avg_sq"] for st in states], updates, scal, noop,
            group["adam_w_mode"])
        multi_tensor_lamb_stage2(updates, targets, copies, u_sq, p_sq,
                                 device_scalars((group["lr"],), device),
                                 noop, group["use_nvlamb"])


    # -- the packed bucket form (ZeRO shards) --------------------------------

    @staticmethod
    def _init_bucket(rows, device):
        return {"m": torch.zeros((rows, 128), dtype=_f32, device=device),
                "v": torch.zeros((rows, 128), dtype=_f32, device=device)}

    def _pre_step_bucketed(self, g_views, grad_scale, sum_across):
        """The clip factor from the global norm: #17 over this rank's
        gradient segments, the sum across the ranks."""
        if g_views:
            total = multi_tensor_sumsq(g_views)[0]
        else:
            total = torch.zeros((), dtype=_f32,
                                device=self.param_groups[0]["params"][0]
                                .device)
        return self._clip_factor(sum_across(total.reshape(1)).reshape(()),
                                 grad_scale)

    def _chunk_map(self, info, segments, device):
        """Per bucket: the tensor of each stage-1 chunk partial, the index
        of each segment's first chunk, and each segment's tensor."""
        hit = self._chunk_maps.get(info.key)
        if hit is None:
            counts = chunk_counts([(s.stop - s.start) * 128
                                   for s in segments])
            seg_tensor = np.array([s.index for s in segments], np.int64)
            first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
                np.int64) if segments else np.zeros(0, np.int64)
            hit = tuple(torch.from_numpy(a).to(device) for a in (
                np.repeat(seg_tensor, counts), first, seg_tensor))
            self._chunk_maps[info.key] = hit
        return hit

    def _update_bucket(self, info, group, segments, g, p, st, step_count,
                       grad_scale, noop, clip, sum_across):
        """LAMB on the segments of a bucket shard (``g``, ``p`` and the
        moments are ``(rows, 128)`` buffers, updated in place); the
        per-tensor sums go through ``sum_across`` (the all-reduce over the
        ranks) even where this rank holds no segment."""
        device = p.device
        beta1, beta2 = group["betas"]
        bc1, bc2 = self._bias_corrections(group, step_count)
        beta3 = 1.0 - beta1 if group["grad_averaging"] else 1.0
        of_chunk, first, of_seg = self._chunk_map(info, segments, device)
        sums = torch.zeros((2, len(info.params)), dtype=_f32, device=device)
        if segments:
            u = self._updates.get(info.key)
            if u is None:
                u = self._updates[info.key] = torch.empty_like(p, dtype=_f32)
            scal = device_scalars((beta1, beta2, group["eps"],
                                   group["weight_decay"], bc1, bc2,
                                   grad_scale, clip, beta3), device)
            views = [segment_views(t, segments)
                     for t in (g, p, st["m"], st["v"], u)]
            u_sq, p_sq = multi_tensor_lamb_stage1(*views, scal, noop,
                                                  group["adam_w_mode"])
            sums.index_add_(1, of_chunk, torch.stack([u_sq, p_sq]))
        sums = sum_across(sums)
        if not segments:
            return
        partials = torch.zeros((2, len(of_chunk)), dtype=_f32, device=device)
        partials[:, first] = sums[:, of_seg]
        multi_tensor_lamb_stage2(views[4], views[1], [None] * len(segments),
                                 partials[0], partials[1],
                                 device_scalars((group["lr"],), device),
                                 noop, group["use_nvlamb"])


class FusedMixedPrecisionLamb(FusedLAMB):
    """apex ``fused_mixed_precision_lamb.py``: LAMB with f32 master weights
    and low-precision model parameters — FusedLAMB with
    ``master_weights=True`` (the base class keeps the masters).  Each
    parameter keeps its own dtype: a ``reduced_precision_dtype`` raises
    unless every parameter that is not f32 already has it."""

    def __init__(self, params, reduced_precision_dtype=None, **kw):
        kw.setdefault("master_weights", True)
        self.reduced_precision_dtype = reduced_precision_dtype
        super().__init__(params, **kw)
        if reduced_precision_dtype is not None:
            other = {p.dtype for g in self.param_groups for p in g["params"]
                     if p.dtype not in (_f32, reduced_precision_dtype)}
            if other:
                raise ValueError(
                    f"FusedMixedPrecisionLamb: reduced_precision_dtype="
                    f"{reduced_precision_dtype} but parameters of "
                    f"{sorted(map(str, other))} are given; the model "
                    "parameters keep their own dtype, cast them first")
