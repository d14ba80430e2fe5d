"""Stage-to-stage transfers — port of
``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``.

A hop is a shift of a tensor (or a tuple / list of them) one stage along
the ``pipe`` process group, by :func:`torch.distributed.batch_isend_irecv`
(apex's own transport).  Every rank posts the same ordered list of
operations: for each tensor its send, then its receive.  Shapes are the
sender's, so there is no shape handshake (the ring carries one shape).

With ``wrap=False`` (default) the boundary stage receives zeros (apex's
"the first stage receives nothing"); ``wrap=True`` keeps the wrap value,
which the interleaved schedule uses to hand a micro-batch to the next
virtual chunk.  At a group of one stage the hop is local: the wrap hop
hands the tensor back as it is (NCCL refuses a send to oneself).

The hops are autograd Functions: the backward of a forward shift is the
masked shift the other way (with ``wrap=True`` exactly the inverse
permutation), as the JAX ``custom_vjp`` defines it.  The ring engine of
:mod:`.ring` never differentiates through them — it moves cotangents as
plain data with :func:`exchange` — but code composing the half-ops under
autograd gets the counter-rotating ring.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import check_backend, flatten_tree

__all__ = ["send_forward_recv_forward", "send_backward_recv_backward",
           "send_forward", "recv_forward", "send_backward", "recv_backward",
           "send_forward_recv_backward", "send_backward_recv_forward",
           "exchange"]


def _group(axis_name):
    group = ps.resolve_group(axis_name)
    return None if ps.group_size(group) == 1 else group


def exchange(forward, backward, group):
    """One tick of both rings in one ``batch_isend_irecv``: each tensor of
    ``forward`` to the next stage and each of ``backward`` to the previous
    one; returns what arrives ``(from the previous, from the next)``.  At
    one stage (``group`` None) both come back as they are."""
    if group is None:
        return list(forward), list(backward)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    ops, fwd_in, bwd_in = [], [], []
    for tag, (tensors, to, frm, outs) in enumerate(
            ((forward, nxt, prv, fwd_in), (backward, prv, nxt, bwd_in))):
        for i, x in enumerate(tensors):
            x = x.contiguous()
            check_backend(x, group, "pipeline hop")
            o = torch.empty_like(x)
            outs.append(o)
            ops.append(dist.P2POp(dist.isend, x, to, group,
                                  tag=2 * i + tag))
            ops.append(dist.P2POp(dist.irecv, o, frm, group,
                                  tag=2 * i + tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return fwd_in, bwd_in


def _shift_impl(leaves, group, forward, wrap):
    if group is None:
        out = [v.view_as(v) for v in leaves]
        n, s = 1, 0
    else:
        moved, back = exchange(leaves if forward else [],
                               [] if forward else leaves, group)
        out = moved if forward else back
        n, s = dist.get_world_size(group), dist.get_rank(group)
    if not wrap and s == (0 if forward else n - 1):
        out = [torch.zeros_like(v) for v in out]
    return out


class _Shift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, forward, wrap, *leaves):
        ctx.group, ctx.forward, ctx.wrap = group, forward, wrap
        return tuple(_shift_impl(leaves, group, forward, wrap))

    @staticmethod
    def backward(ctx, *grads):
        # the transpose of (edge mask . permute) is the opposite masked
        # shift; with wrap the permute is a bijection and this its inverse
        back = _shift_impl(list(grads), ctx.group, not ctx.forward, ctx.wrap)
        return (None, None, None, *back)


def _shift(tree, axis_name, forward, wrap):
    leaves, rebuild = flatten_tree(tree)
    return rebuild(list(_Shift.apply(_group(axis_name), forward, wrap,
                                     *leaves)))


def send_forward_recv_forward(output_tensor, *,
                              axis_name: str = ps.PIPELINE_AXIS,
                              wrap: bool = False):
    """Send to the next stage, receive from the previous (one hop): apex's
    ``send_forward`` / ``recv_forward`` pair as one exchange."""
    return _shift(output_tensor, axis_name, True, wrap)


def send_backward_recv_backward(input_tensor_grad, *,
                                axis_name: str = ps.PIPELINE_AXIS,
                                wrap: bool = False):
    """Gradient hop toward earlier stages (apex ``send_backward`` /
    ``recv_backward``)."""
    return _shift(input_tensor_grad, axis_name, False, wrap)


def send_forward(output_tensor, **kw):
    return send_forward_recv_forward(output_tensor, **kw)


def recv_forward(tensor_like, **kw):
    return send_forward_recv_forward(tensor_like, **kw)


def send_backward(input_tensor_grad, **kw):
    return send_backward_recv_backward(input_tensor_grad, **kw)


def recv_backward(tensor_like, **kw):
    return send_backward_recv_backward(tensor_like, **kw)


def send_forward_recv_backward(output_tensor, grad_like, *,
                               axis_name: str = ps.PIPELINE_AXIS):
    """The 1F1B steady state's exchange: activations go forward while
    gradients come backward."""
    return (send_forward_recv_forward(output_tensor, axis_name=axis_name),
            send_backward_recv_backward(grad_like, axis_name=axis_name))


def send_backward_recv_forward(input_tensor_grad, act_like, *,
                               axis_name: str = ps.PIPELINE_AXIS):
    return (send_backward_recv_backward(input_tensor_grad,
                                        axis_name=axis_name),
            send_forward_recv_forward(act_like, axis_name=axis_name))
