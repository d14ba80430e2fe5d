"""Transducer (RNN-T) ops — port of ``apex_tpu/contrib/transducer/__init__.py``
(apex ``TransducerJoint`` / ``TransducerLoss``).

* :func:`transducer_joint`: ``h[b, t, u] = f[b, t] + g[b, u]`` with the
  optional fused ReLU and dropout (a Bernoulli mask from a
  :class:`torch.Generator`), and the optional packed output: each sample's
  valid ``(t, u)`` rectangle at rows ``batch_offsets[b] + t * g_len[b] + u``
  of a ``(packed_batch, H)`` buffer, rows out of range dropped.
* :func:`transducer_loss`: the RNN-T negative log-likelihood of the JAX
  alpha recurrence (``_loss_single_lattice``): ``alpha[t, u] =
  logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] + emit[t, u-1])``
  over the columns ``u <= y_len``, and the loss ``-(alpha[f_len-1, y_len] +
  blank[f_len-1, y_len])``.  JAX freezes the rows past ``f_len``; they are
  never read, so here they are computed and left.  The lattice is walked by
  anti-diagonals ``d = t + u``: T + U steps, each vectorised over the batch
  and the diagonal, autograd through the walk.  The blank and label
  log-probabilities are taken in one gather, so the backward scatters into
  one ``(B, T, U+1, V)`` gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss"]

_f32 = torch.float32
_NEG = -1e30


def transducer_joint(f, g, f_len=None, g_len=None, pack_output=False,
                     relu=False, dropout_prob=0.0, generator=None,
                     batch_offsets=None, packed_batch=None):
    """``f (B, T, H) + g (B, U1, H)`` -> ``(B, T, U1, H)``, or packed
    ``(packed_batch, H)``; ``generator`` seeds the dropout mask."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = torch.relu(h)
    if dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout needs a generator")
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1.0 - dropout_prob
        h = torch.where(keep, h / (1.0 - dropout_prob), 0.0)
    if not pack_output:
        return h
    if f_len is None or g_len is None or batch_offsets is None \
            or packed_batch is None:
        raise ValueError("pack_output needs f_len, g_len, batch_offsets "
                         "and a packed_batch")
    b, t_max, u_max, hidden = h.shape
    dev = h.device
    f_len, g_len, offsets = (torch.as_tensor(v, device=dev).long()[
        :, None, None] for v in (f_len, g_len, batch_offsets))
    tt = torch.arange(t_max, device=dev)[None, :, None]
    uu = torch.arange(u_max, device=dev)[None, None, :]
    dest = offsets + tt * g_len + uu
    keep = (tt < f_len) & (uu < g_len) & (dest >= 0) & (dest < packed_batch)
    dest = torch.where(keep, dest, packed_batch)     # the dropped row
    out = h.new_zeros((packed_batch + 1, hidden))
    out = out.index_put((dest.reshape(-1),), h.reshape(-1, hidden))
    return out[:packed_batch]


def _lattice_end(alphas, blank, f_len, y_len):
    """``alpha[f_len-1, y_len] + blank[f_len-1, y_len]`` per sample, from
    the diagonals ``alphas (B, D, T)`` and ``blank (B, T, U1)``."""
    rows = torch.arange(blank.shape[0], device=blank.device)
    t = f_len - 1
    return alphas[rows, t + y_len, t] + blank[rows, t, y_len]


def transducer_loss(x, label, f_len, y_len, blank_idx=0):
    """RNN-T NLL per sample: ``x (B, T, U+1, V)`` log-probs, ``label (B,
    U)``, lengths ``(B,)``; returns ``(B,)`` f32 losses."""
    x = x.to(_f32)
    b, t_max, u1, _ = x.shape
    dev = x.device
    label = torch.as_tensor(label, device=dev).long()
    f_len = torch.as_tensor(f_len, device=dev).long()
    y_len = torch.as_tensor(y_len, device=dev).long()
    # one gather of (blank, label[u]) per cell; the last column's label
    # slot is never read
    lab = F.pad(label, (0, 1), value=blank_idx)                  # (B, U1)
    idx = torch.stack([torch.full_like(lab, blank_idx), lab], -1)
    pair = torch.gather(x, 3, idx[:, None].expand(b, t_max, u1, 2))
    blank, emit = pair[..., 0], pair[..., 1]                 # (B, T, U1)
    # skewed to diagonals: sk[b, d, t] = cell (t, u = d - t)
    n_diag = t_max + u1 - 1
    t_ids = torch.arange(t_max, device=dev)
    u = torch.arange(n_diag, device=dev)[:, None] - t_ids[None, :]
    inside = (u >= 0) & (u < u1)                                 # (D, T)
    u_idx = u.clamp(0, u1 - 1)[None].expand(b, n_diag, t_max)
    blank_sk = torch.gather(blank.transpose(1, 2), 1, u_idx)     # (B, D, T)
    emit_sk = torch.gather(emit.transpose(1, 2), 1, u_idx)
    valid = inside[None] & (u[None] <= y_len[:, None, None])     # (B, D, T)
    alpha = torch.where(t_ids == 0, 0.0, _NEG).to(_f32).expand(b, t_max)
    alphas = [alpha]
    for d in range(1, n_diag):
        # from (t-1, u) by a blank: position t-1 of the last diagonal
        from_blank = F.pad((alpha + blank_sk[:, d - 1])[:, :-1], (1, 0),
                           value=_NEG)
        # from (t, u-1) by an emission: position t of the last diagonal
        from_emit = alpha + emit_sk[:, d - 1]
        alpha = torch.where(valid[:, d], torch.logaddexp(from_blank,
                                                         from_emit), _NEG)
        alphas.append(alpha)
    return -_lattice_end(torch.stack(alphas, 1), blank, f_len, y_len)


class TransducerJoint(nn.Module):
    """apex ``TransducerJoint`` module surface."""

    def __init__(self, pack_output=False, relu=False, dropout=False,
                 dropout_prob=0.0, probe_mask=False):
        super().__init__()
        del probe_mask
        self.pack_output = bool(pack_output)
        self.relu = bool(relu)
        self.dropout_prob = float(dropout_prob) if dropout else 0.0

    def forward(self, f, g, f_len=None, g_len=None, batch_offsets=None,
                packed_batch=None, generator=None):
        return transducer_joint(
            f, g, f_len, g_len, pack_output=self.pack_output,
            relu=self.relu, dropout_prob=self.dropout_prob,
            generator=generator, batch_offsets=batch_offsets,
            packed_batch=packed_batch)


class TransducerLoss(nn.Module):
    """apex ``TransducerLoss`` module surface (dense input only)."""

    def __init__(self, fuse_softmax_backward=True, opt=1,
                 packed_input=False):
        super().__init__()
        if packed_input:
            raise ValueError("packed_input is not supported; pass the "
                             "dense (B, T, U+1, V) log-probs")
        del fuse_softmax_backward, opt

    def forward(self, x, label, f_len, y_len, blank_idx=0):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
