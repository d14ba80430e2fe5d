"""Data parallelism — port of ``apex_tpu/parallel/distributed.py`` (apex
``apex/parallel/distributed.py``).

* :func:`allreduce_gradients` — reduce a gradient tensor, list or dict
  across the data-parallel group (one all-reduce per dtype), averaged.
* :class:`DistributedDataParallel` — apex's module wrapper: the parameters
  are broadcast from rank 0 at construction; after each backward the
  gradients are reduced in buckets of ``message_size`` bytes, in reverse
  creation order, one flat collective a bucket, launched from
  per-parameter post-accumulate hooks as soon as a bucket's last gradient
  is in (``delay_allreduce=True``: every bucket once, at the end of the
  backward); :meth:`~DistributedDataParallel.no_sync` accumulates
  micro-batches locally.  The reduction keeps the JAX ``reduce``'s
  arithmetic: ``allreduce_always_fp32``, ``gradient_average``,
  ``gradient_predivide_factor`` staged as ``/ factor``, the sum, then ``*
  factor / n``, and ``allreduce_dtype`` through
  :mod:`apex_tpu_torch.utils.compressed_allreduce` (a bucket is laid out as
  the packed rows of its tensors, so each tensor quantizes as the JAX
  package's per-leaf compressed sum does).
* :class:`Reducer` — the manual-trigger reduction.

A model whose parameters a ZeRO optimizer
(:mod:`apex_tpu_torch.parallel.distributed_optimizer`) steps needs no DDP
reduction: that optimizer's reduce-scatter is the reduction, and it
refuses the parameters of a DDP module (:func:`owner_of`).

NCCL-stream knobs (``num_allreduce_streams``, ``allreduce_communicators``,
``retain_allreduce_buffers``, ``shared_param``,
``allreduce_trigger_params``, ``prof``) are accepted and unused.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.multi_tensor_apply import bucketing as B
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import compressed_allreduce as CA
from apex_tpu_torch.utils.collectives import (check_backend, flatten_tree,
                                              psum_if_varying, tree_map)
from apex_tpu_torch.utils.device import resolve_device

DEFAULT_DATA_AXIS = ps.DATA_AXIS

__all__ = ["DistributedDataParallel", "Reducer", "allreduce_gradients",
           "DEFAULT_DATA_AXIS"]

def allreduce_gradients(grads, axis_name: str = DEFAULT_DATA_AXIS,
                        average: bool = True, strict: bool = False, *,
                        process_group=None):
    """Reduce a gradient tensor, list, tuple or dict across the
    data-parallel group (new tensors); ``average`` divides by the group's
    size (apex ``gradient_average``).  ``strict`` as in
    :func:`~apex_tpu_torch.utils.collectives.psum_if_varying`."""
    group = ps.resolve_group(axis_name, process_group)
    reduced = psum_if_varying(grads, strict=strict, process_group=group,
                              axis_name=None)
    if average:
        n = ps.group_size(group)
        reduced = tree_map(lambda g: g / n, reduced)
    return reduced


def owner_of(param) -> Optional["DistributedDataParallel"]:
    """The :class:`DistributedDataParallel` reducing ``param``'s gradient,
    or None."""
    ref = getattr(param, "_apex_ddp_owner", None)
    return None if ref is None else ref()


class _Bucket:
    def __init__(self, params):
        self.params = params
        self.meta = B.bucket_meta([tuple(p.shape) for p in params],
                                  params[0].dtype, block_rows=1)
        self.ready = 0
        self.done = False


class DistributedDataParallel(nn.Module):
    """apex ``DistributedDataParallel(module, message_size, delay_allreduce,
    ..., gradient_average, gradient_predivide_factor)`` plus the JAX
    package's ``allreduce_dtype`` and ``axis_name`` / ``process_group``.

    ``forward`` is the module's.  After ``loss.backward()`` every
    parameter's ``.grad`` holds the reduced gradient (the average over the
    group by default); a parameter the backward did not reach gets a zero
    gradient, so every rank reduces the same buckets.
    """

    def __init__(self, module: nn.Module, message_size: int = 10_000_000,
                 delay_allreduce: bool = False, shared_param=None,
                 allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_dtype=None, prof: bool = False, *,
                 axis_name: str = DEFAULT_DATA_AXIS, process_group=None):
        super().__init__()
        del (shared_param, allreduce_trigger_params,
             retain_allreduce_buffers, num_allreduce_streams,
             allreduce_communicators, prof)      # NCCL-stream knobs
        self.module = module
        self.message_size = int(message_size)
        self.delay_allreduce = bool(delay_allreduce)
        self.allreduce_always_fp32 = bool(allreduce_always_fp32)
        self.gradient_average = bool(gradient_average)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.allreduce_dtype = CA.check_mode(allreduce_dtype)
        self.axis_name = axis_name
        self.process_group = ps.resolve_group(axis_name, process_group)
        if self.allreduce_dtype is not None and self.process_group is None:
            raise ValueError(
                f"allreduce_dtype={allreduce_dtype!r} needs the compressed "
                "collectives' world size: initialise torch.distributed (or "
                "pass process_group=) so it can be read from the group")
        params = [p for p in module.parameters() if p.requires_grad]
        if not params:      # nothing to place it: the default device
            resolve_device(None)
        self.world_size = ps.group_size(self.process_group)
        self._sync = True
        self._queued = False
        self.broadcast_params()
        self._buckets = self._make_buckets(params)
        self._bucket_of = {}
        for b in self._buckets:
            for p in b.params:
                self._bucket_of[p] = b
                p._apex_ddp_owner = weakref.ref(self)
                p.register_post_accumulate_grad_hook(self._grad_ready)

    # -- layout --------------------------------------------------------------

    def _make_buckets(self, params):
        """Buckets of at most ``message_size`` bytes over the parameters in
        reverse creation order (the order the backward produces them), one
        dtype a bucket."""
        order = list(reversed(params))
        buckets = []
        for idx in B.group_by_dtype(order).values():
            shapes = [tuple(order[i].shape) for i in idx]
            for part in B.split_by_message_size(shapes, order[idx[0]].dtype,
                                                self.message_size):
                buckets.append(_Bucket([order[idx[k]] for k in part]))
        return buckets

    # -- the GSPMD-path helpers of the JAX wrapper -------------------------

    @torch.no_grad()
    def broadcast_params(self):
        """Every rank takes rank 0's parameters (apex's init-time
        broadcast)."""
        group = self.process_group
        if group is None:
            return
        src = dist.get_global_rank(group, 0)
        for p in self.module.parameters():
            check_backend(p, group, "broadcast")
            dist.broadcast(p.data, src, group=group)

    def scatter(self, batch):
        """This rank's rows of a global batch (a tensor, list, tuple or
        dict of tensors): the leading axis split into ``world`` equal
        contiguous parts, part ``r`` to rank ``r`` (the JAX package's
        ``P("data")`` sharding)."""
        n, r = self.world_size, ps.group_rank(self.process_group)

        def one(x):
            if x.shape[0] % n:
                raise ValueError(f"batch of {x.shape[0]} rows does not "
                                 f"split over {n} ranks")
            k = x.shape[0] // n
            return x[r * k:(r + 1) * k]
        return tree_map(one, batch)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    # -- micro-batches -------------------------------------------------------

    @contextlib.contextmanager
    def no_sync(self):
        """Backward passes inside the block accumulate ``.grad`` locally;
        the first backward after it reduces the sum."""
        old, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = old

    @staticmethod
    def accumulate(acc, grads, main_grad_dtype=None):
        """Micro-batch gradient accumulation (the functional form of the
        JAX wrapper): ``acc + grads`` leaf by leaf (``grads`` cast to
        ``main_grad_dtype`` first when given), or ``grads`` when ``acc``
        is None."""
        gs, rebuild = flatten_tree(grads)
        if main_grad_dtype is not None:
            gs = [g.to(main_grad_dtype) for g in gs]
        if acc is not None:
            gs = [a + g for a, g in zip(flatten_tree(acc)[0], gs)]
        return rebuild(gs)

    # -- the reduction -------------------------------------------------------

    def _psum(self, flat):
        if self.allreduce_dtype is None:
            if self.process_group is not None:
                check_backend(flat, self.process_group, "all_reduce")
                dist.all_reduce(flat, group=self.process_group)
            return flat
        return CA.psum_rows(flat, self.allreduce_dtype,
                            process_group=self.process_group)

    def _reduce_rows(self, rows):
        """The JAX ``reduce`` arithmetic on one packed buffer."""
        if self.allreduce_always_fp32:
            rows = rows.to(torch.float32)
        factor = self.gradient_predivide_factor
        n = self.world_size
        if factor != 1.0:
            out = self._psum(rows / factor)
            return out * (factor / n) if self.gradient_average else out
        out = self._psum(rows)
        return out / n if self.gradient_average else out

    def reduce(self, grads):
        """The reduction of a gradient tensor, list, tuple or dict (new
        tensors), as the hooks reduce a bucket."""
        leaves, rebuild = flatten_tree(grads)
        out = list(leaves)
        for idx in B.group_by_dtype(leaves).values():
            ts = [leaves[i] for i in idx]
            meta = B.bucket_meta([tuple(t.shape) for t in ts], ts[0].dtype,
                                 block_rows=1)
            red = self._reduce_rows(B.flatten_bucket(ts, meta))
            for i, t in zip(idx, B.unflatten_bucket(red, meta)):
                out[i] = t
        return rebuild(out)

    @torch.no_grad()
    def _reduce_bucket(self, bucket):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in bucket.params]
        red = self._reduce_rows(B.flatten_bucket(grads, bucket.meta))
        for p, g in zip(bucket.params, B.unflatten_bucket(red,
                                                          bucket.meta)):
            if p.grad is None:
                p.grad = g.to(p.dtype).clone()
            else:
                p.grad.copy_(g)
        bucket.done = True

    def _grad_ready(self, param):
        if not self._sync:
            return
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish_backward)
        bucket = self._bucket_of[param]
        bucket.ready += 1
        if not self.delay_allreduce and bucket.ready == len(bucket.params):
            self._reduce_bucket(bucket)

    def _finish_backward(self):
        """End of a backward: reduce every bucket not reduced yet (all of
        them under ``delay_allreduce``, else those with a parameter the
        backward did not reach), in bucket order, then reset."""
        self._queued = False
        for bucket in self._buckets:
            if not bucket.done:
                self._reduce_bucket(bucket)
            bucket.ready, bucket.done = 0, False


class Reducer:
    """apex ``Reducer``: a reduction you trigger.  ``Reducer(module or a
    list of parameters)``; ``reduce()`` reduces their ``.grad`` in place,
    ``reduce(tree)`` returns a reduced copy of a gradient tree."""

    def __init__(self, module_or_grads_list=None,
                 axis_name: str = DEFAULT_DATA_AXIS, *, process_group=None):
        self.axis_name = axis_name
        self.process_group = ps.resolve_group(axis_name, process_group)
        if isinstance(module_or_grads_list, nn.Module):
            self.params = list(module_or_grads_list.parameters())
        else:
            self.params = list(module_or_grads_list or [])

    def reduce(self, tree=None, average: bool = True):
        if tree is not None:
            return allreduce_gradients(tree, average=average, axis_name=None,
                                       process_group=self.process_group)
        params = [p for p in self.params if p.grad is not None]
        if params:
            out = allreduce_gradients([p.grad for p in params],
                                      average=average, axis_name=None,
                                      process_group=self.process_group)
            with torch.no_grad():
                for p, g in zip(params, out):
                    p.grad.copy_(g)
        return None
