"""apex.RNN surface (deprecated upstream) — port of ``apex_tpu/RNN/__init__.py``.

Each factory returns an ``nn.Module`` whose ``apply(x, h0=None)`` (also its
``forward``) takes ``x`` of shape ``(seq, batch, input)``, the reference's
time-major layout, and returns ``(outputs (seq, batch, hidden),
final_states)``: one state tuple per layer, ``(h, c)`` for the LSTM and
``(h,)`` for the others, exactly what ``h0`` takes back to resume.

The JAX recurrence is a ``lax.scan`` (no kernel), so here it is a plain
step loop.  Each layer holds ``i2h`` and ``h2h`` as ``nn.Linear``; the JAX
weights are ``(n_in, n_out)`` (``x @ W``), and
:func:`apex_tpu_torch.convert.rnn_params_from_jax` transposes them.  Gates
are split in the JAX order: i, f, g, o (LSTM) and r, z, n (GRU).
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from apex_tpu_torch.utils.device import resolve_device

__all__ = ["LSTM", "GRU", "RNNTanh", "RNNReLU"]


def _deprecated():
    # called from the public factory functions: _deprecated(1) ->
    # factory(2) -> USER(3); constructors don't warn, so the level is the
    # same for every entry point
    warnings.warn(
        "apex_tpu_torch.RNN is deprecated surface parity with apex.RNN; use "
        "torch.nn recurrent layers for new code", DeprecationWarning,
        stacklevel=3)


class _Recurrent(nn.Module):
    """Shared step loop over a per-step cell."""

    n_gates = 1
    n_state = 1          # 1: h only; 2: (h, c)

    def __init__(self, input_size, hidden_size, num_layers=1, bias=True,
                 dropout=0.0, device=None):
        super().__init__()
        if dropout:
            warnings.warn("dropout ignored (parity-only kwarg)")
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.bias = bool(bias)
        dev = resolve_device(device)
        width = self.n_gates * self.hidden_size
        self.layers = nn.ModuleList()
        for layer in range(self.num_layers):
            n_in = self.input_size if layer == 0 else self.hidden_size
            self.layers.append(nn.ModuleDict({
                "i2h": nn.Linear(n_in, width, bias=self.bias, device=dev),
                "h2h": nn.Linear(self.hidden_size, width, bias=self.bias,
                                 device=dev)}))

    def init_params(self, generator=None):
        """U(-1/sqrt(n_in), 1/sqrt(n_in)) weights and biases, the JAX
        ``_linear_init``; returns the module."""
        with torch.no_grad():
            for p in self.layers:
                for lin in p.values():
                    bound = lin.in_features ** -0.5
                    for t in lin.parameters():
                        t.copy_(torch.rand(t.shape, generator=generator)
                                .mul_(2 * bound).sub_(bound))
        return self

    def _cell(self, p, x_t, state):
        raise NotImplementedError

    def forward(self, x, h0=None):
        """Returns ``(outputs (seq, batch, hidden), final_states)``.

        ``h0``: optional initial states, a list with one state tuple per
        layer, exactly the ``final_states`` a previous call returned (so
        resuming is ``m.apply(x2, h0=states)``).
        """
        batch = x.shape[1]
        if h0 is not None and len(h0) != self.num_layers:
            raise ValueError(
                f"h0 must be a list of {self.num_layers} per-layer state "
                "tuples (as returned in final_states)")
        states = []
        for layer, p in enumerate(self.layers):
            if h0 is None:
                zero = x.new_zeros((batch, self.hidden_size),
                                   dtype=torch.float32)
                state = (zero,) * self.n_state
            else:
                state = tuple(h0[layer])
            outs = []
            for x_t in x.unbind(0):
                state = self._cell(p, x_t, state)
                outs.append(state[0])
            x = torch.stack(outs)
            states.append(state)
        return x, states

    def apply(self, x, h0=None):
        """The reference's ``apply(x, h0)``; a callable (not a tensor) is
        ``nn.Module.apply(fn)``, which a parent module's ``apply`` calls."""
        if not isinstance(x, torch.Tensor):
            return super().apply(x)
        return self(x, h0)


class _LSTM(_Recurrent):
    n_gates, n_state = 4, 2

    def _cell(self, p, x_t, state):
        h, c = state
        g = p["i2h"](x_t) + p["h2h"](h)
        i, f, gc, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gc)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c


class _GRU(_Recurrent):
    n_gates = 3

    def _cell(self, p, x_t, state):
        (h,) = state
        i_r, i_z, i_n = p["i2h"](x_t).chunk(3, dim=-1)
        h_r, h_z, h_n = p["h2h"](h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return ((1 - z) * n + z * h,)


class _RNN(_Recurrent):
    def __init__(self, *args, nonlinearity=torch.tanh, **kw):
        super().__init__(*args, **kw)
        self.nonlinearity = nonlinearity

    def _cell(self, p, x_t, state):
        (h,) = state
        return (self.nonlinearity(p["i2h"](x_t) + p["h2h"](h)),)


def LSTM(input_size, hidden_size, num_layers=1, **kw):
    """Reference ``apex.RNN.models.LSTM`` factory."""
    _deprecated()
    return _LSTM(input_size, hidden_size, num_layers, **kw)


def GRU(input_size, hidden_size, num_layers=1, **kw):
    _deprecated()
    return _GRU(input_size, hidden_size, num_layers, **kw)


def RNNTanh(input_size, hidden_size, num_layers=1, **kw):
    _deprecated()
    return _RNN(input_size, hidden_size, num_layers, nonlinearity=torch.tanh,
                **kw)


def RNNReLU(input_size, hidden_size, num_layers=1, **kw):
    _deprecated()
    return _RNN(input_size, hidden_size, num_layers, nonlinearity=torch.relu,
                **kw)
