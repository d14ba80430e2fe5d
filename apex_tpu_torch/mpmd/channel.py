"""Explicit slow-link (DCN) channel between MPMD stage programs — port of
``apex_tpu/mpmd/channel.py``.

Across pods there is no shared program: stage boundaries move through a
*channel* object — an explicit, host-driven transfer with its own failure
mode (:class:`DcnTimeout`, retryable) and its own cost (per-hop latency
alpha + inverse bandwidth beta).

:class:`LocalDcnChannel` is the single-process realisation: each tensor of
the payload round-trips through host memory (``tensor.to("cpu")`` and
back onto its device), which preserves bytes exactly.  Latency is
*accounted*, not slept (``simulated_seconds``).  Faults come from the
shared :class:`~apex_tpu_torch.resilience.faults.FaultInjector` (kind
``"dcn_fault"``): one scheduled fault drops one transfer attempt, and
because :meth:`~apex_tpu_torch.resilience.faults.FaultInjector.check_dcn`
consumes the fault, a retry of the SAME send succeeds.

:meth:`LocalDcnChannel.from_cost_model` prices the link off a fitted
:class:`~apex_tpu_torch.observability.costmodel.CostModel` (its ``dcn``
``ppermute`` curve).  :class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline`
moves its stage boundaries and the tied-embedding sync over this channel,
and the disaggregated serving fleet its KV blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["DcnTimeout", "Edge", "LocalDcnChannel"]


def _tree_map(fn, tree):
    """``fn`` over every tensor of a dict / list / tuple nest."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"cannot send a {type(tree).__name__}")


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


class DcnTimeout(RuntimeError):
    """A cross-pod transfer dropped or timed out.  Retryable: the
    payload is still owned by the sending stage, so the engine
    re-issues the identical send (bounded by the channel's
    ``max_retries``)."""

    def __init__(self, step: int, edge: "Edge", attempt: int):
        super().__init__(
            f"DCN transfer {edge.src}->{edge.dst} dropped at step "
            f"{step} (attempt {attempt})")
        self.step = step
        self.edge = edge
        self.attempt = attempt


@dataclasses.dataclass(frozen=True)
class Edge:
    """One directed stage boundary; ``link_class`` decides whether the
    channel's DCN pricing/faulting applies (``"ici"`` edges transfer
    for free — they model same-pod hops routed through the engine for
    uniformity)."""
    src: int
    dst: int
    link_class: str = "dcn"


class LocalDcnChannel:
    """Single-process DCN channel: byte-exact host round-trip plus
    accounted latency and injectable faults.

    ``alpha_s``/``beta_s_per_byte`` price a transfer as
    ``alpha + beta * nbytes``; alternatively
    :meth:`from_cost_model` pulls the coefficients from a fitted
    ``dcn`` ``ppermute`` curve so the channel and a planner price the
    same fabric identically.
    """

    def __init__(self, *, alpha_s: float = 0.0,
                 beta_s_per_byte: float = 0.0,
                 fault_injector=None, max_retries: int = 2):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {max_retries}")
        self.alpha_s = float(alpha_s)
        self.beta_s_per_byte = float(beta_s_per_byte)
        self.fault_injector = fault_injector
        self.max_retries = int(max_retries)
        # -- transfer ledger (tests + bench read these) ---------------
        self.sends = 0
        self.retries = 0
        self.bytes_sent = 0
        self.simulated_seconds = 0.0

    @classmethod
    def from_cost_model(cls, cost_model, *, link_class: str = "dcn",
                        **kw) -> "LocalDcnChannel":
        """Build from a fitted :class:`CostModel`: a point-to-point
        hop is priced off the ``ppermute`` curve of ``link_class``
        (every ring op reduces to per-hop alpha + per-byte beta)."""
        fit = cost_model._fit_for("ppermute", "f32", link_class)
        return cls(alpha_s=fit.alpha_s,
                   beta_s_per_byte=fit.beta_s_per_byte, **kw)

    # -- transfer ---------------------------------------------------------

    def transfer_seconds(self, nbytes: int) -> float:
        return self.alpha_s + self.beta_s_per_byte * float(nbytes)

    @staticmethod
    def _nbytes(tree: Any) -> int:
        return sum(x.numel() * x.element_size() for x in _leaves(tree))

    def send(self, value: Any, dst_device: Any = None, *,
             step: int = 0, edge: Optional[Edge] = None,
             _attempt: int = 0) -> Any:
        """One transfer attempt of ``value`` (a tensor, or a dict / list /
        tuple of tensors): every tensor is copied to host memory and back
        onto ``dst_device`` (default: the device it came from).  The
        host copy is synchronous, so the source storage may be reused as
        soon as this returns.  Raises :class:`DcnTimeout` when a
        ``dcn_fault`` is scheduled for this ``step`` on a DCN-class
        edge."""
        edge = edge if edge is not None else Edge(-1, -1)
        dcn = edge.link_class == "dcn"
        if dcn and self.fault_injector is not None \
                and self.fault_injector.check_dcn(step) is not None:
            raise DcnTimeout(step, edge, _attempt)
        nbytes = self._nbytes(value)
        out = _tree_map(
            lambda x: x.detach().to("cpu", copy=True).to(
                x.device if dst_device is None else dst_device), value)
        self.sends += 1
        self.bytes_sent += nbytes
        if dcn:
            self.simulated_seconds += self.transfer_seconds(nbytes)
        return out

    def send_with_retry(self, value: Any, dst_device: Any = None, *,
                        step: int = 0,
                        edge: Optional[Edge] = None) -> Any:
        """The engine's send: retry :class:`DcnTimeout` up to
        ``max_retries`` times (each consumed fault frees the retry to
        succeed); re-raises when the budget is exhausted."""
        last: Optional[DcnTimeout] = None
        for attempt in range(self.max_retries + 1):
            try:
                return self.send(value, dst_device, step=step,
                                 edge=edge, _attempt=attempt)
            except DcnTimeout as e:
                last = e
                self.retries += 1
        assert last is not None
        raise last
