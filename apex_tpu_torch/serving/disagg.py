"""Disaggregated prefill/decode serving: two pools, one fleet.

A monolithic replica interleaves two workloads with opposite resource
shapes: prefill is compute-bound and bursty (TTFT is its SLO), decode
is memory-bandwidth-bound and steady (TPOT).  Co-locating them means a
long prompt's chunks steal decode ticks and a deep decode batch delays
first tokens — each pool's tail latency is set by the OTHER pool's
load.  :class:`DisaggregatedFleet` splits them: a **prefill pool** of
``prefill_only=True`` :class:`~apex_tpu_torch.serving.PagedInferenceEngine`
replicas that run chunked prefill and then *park* (never decode), and
a **decode pool** of ordinary replicas that never see a raw prompt —
each request's KV state moves between them exactly once.

The handoff is the block-shipping generalization of the fleet's
migration machinery.  ``export_kv()`` strips a parked request off its
prefill replica WITH the raw storage of every block backing its
``kv_len`` positions; :class:`KvChannel` moves those bytes over an
explicit priced link (per-byte alpha/beta, consume-once ``dcn_fault``
retry; each tensor goes device -> host -> device);
``adopt_kv()`` installs them on a decode replica and resumes the
``(seed, token-index)`` sampling stream — no re-prefill, token-BITWISE
the single-pool stream because paged attention only ever gathers the
block storage the payload is a literal copy of.  Every failure mode
degrades to an existing, proven path:

* channel retries exhausted (handoff lost) → **re-prefill fallback**:
  the decode pool adopts ``prompt + generated`` through the ordinary
  :meth:`~apex_tpu_torch.serving.fleet.FleetRouter._migrate` machinery —
  slower, still bitwise;
* decode pool full (``QueueFull``) → the handoff is buffered and
  re-attempted next tick, then falls back the same way (delayed,
  never lost);
* prefill replica killed with parked work → the fleet's death
  migration re-prefills it on a prefill peer, and the handoff happens
  from there (exactly-once: ``export_kv`` is terminal-no-Response on
  the source, deduplicated collection on both routers).

Quantized decode KV: build the decode pool over
:class:`~apex_tpu_torch.serving.QuantizedPagedKVCache` (``kv_quant="int8"``
on BOTH pools — the handoff tags ``kind``/``block_size`` and refuses a
bitwise install across cache kinds) and per-user KV bytes drop ~4× vs
f32 (~2× vs bf16) while the handoff payload shrinks the same ratio —
``serving_kv_handoff_bytes`` is the series the CI leg gates at
< 0.3× the f32 bytes.

Degradation is per-pool: the shared
:class:`~apex_tpu_torch.serving.DegradationLadder` is threaded a
``burn_source`` reading the DECODE pool's SLO burn, because level 2's
actions (prefix-trie flush + context cap) relieve decode KV pressure —
a prefill-pool TTFT burn must not flush the decode cache.  Sizing is
per-pool too: :class:`~apex_tpu_torch.resilience.capacity.
PoolCapacityController` moves replicas between pools on TTFT-burn vs
TPOT-burn with the two-phase reserve→drain→commit protocol.

Fleet series: ``serving_disagg_handoffs_total`` /
``serving_disagg_fallbacks_total`` counters,
``serving_kv_handoff_bytes`` (labelled by cache kind),
``serving_disagg_pending_handoffs`` gauge.  Each handoff stamps a
``kv_handoff`` flow step on the request's trace context between the
prefill hop and the decode hop, so the Perfetto arrow chain reads
prefill-replica → channel → decode-replica end to end
(``FleetCollector.continuity()`` asserts the chains stay unbroken
across the pool boundary).

Port of ``apex_tpu/serving/disagg.py``; it imports no JAX.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.inference.engine import QueueFull, Request, Response
from apex_tpu_torch.mpmd.channel import DcnTimeout, Edge, LocalDcnChannel
from apex_tpu_torch.observability.fleetobs import FlightRecorder, emit_flow
from apex_tpu_torch.serving.engine import KvHandoff
from apex_tpu_torch.serving.fleet import (DegradationLadder, FleetRouter,
                                    ReplicaHealth, ServingFaultInjector,
                                    _InFlight)

__all__ = ["DisaggregatedFleet", "KvChannel"]


class KvChannel(LocalDcnChannel):
    """The prefill→decode KV link: a :class:`LocalDcnChannel` (byte-
    exact host round-trip, priced alpha + beta·bytes, consume-once
    ``dcn_fault`` + bounded retry) that additionally keeps the handoff
    ledger the bench legs read (``handoffs`` / ``handoff_bytes`` /
    ``lost_handoffs``)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.handoffs = 0
        self.handoff_bytes = 0
        self.lost_handoffs = 0

    def send_handoff(self, handoff: KvHandoff, *, step: int = 0,
                     edge: Optional[Edge] = None) -> KvHandoff:
        """Move ``handoff``'s block payload across the link (bytes
        preserved exactly; latency accounted into
        ``simulated_seconds``).  Raises :class:`DcnTimeout` once the
        retry budget is exhausted — the caller's re-prefill fallback
        owns the request from there."""
        try:
            handoff.payload = self.send_with_retry(
                handoff.payload, step=step, edge=edge)
        except DcnTimeout:
            self.lost_handoffs += 1
            raise
        self.handoffs += 1
        self.handoff_bytes += handoff.nbytes()
        return handoff


class _BufferedHandoff:
    """A handoff waiting for decode capacity (bounded retries, then
    the re-prefill fallback)."""

    def __init__(self, handoff: KvHandoff):
        self.handoff = handoff
        self.ticks = 0


class DisaggregatedFleet:
    """Two :class:`~apex_tpu_torch.serving.FleetRouter` pools — prefill and
    decode — behind one placement facade, with the KV handoff between
    them (see the module docstring for the architecture).

    ``submit`` places on the prefill pool (degradation gates included:
    both routers share ``ladder``, whose ``burn_source`` is wired to
    the decode pool's burn unless the caller set one).  ``step`` runs
    one fleet round: decode pool first (so a ladder level change acts
    on decode replicas the tick it trips), then prefill, then the
    handoff pass.  ``completed`` merges both pools' deduplicated
    responses.
    """

    def __init__(self, prefill_replicas: Sequence,
                 decode_replicas: Sequence, *,
                 channel: Optional[KvChannel] = None,
                 clock=time.monotonic,
                 prefill_injector: Optional[ServingFaultInjector] = None,
                 decode_injector: Optional[ServingFaultInjector] = None,
                 ladder: Optional[DegradationLadder] = None,
                 handoff_retry_ticks: int = 8,
                 registry=None, recorder: Optional[FlightRecorder] = None,
                 tracer=None, seed: int = 0,
                 prefill_kw: Optional[dict] = None,
                 decode_kw: Optional[dict] = None):
        for e in prefill_replicas:
            if not getattr(e, "prefill_only", False):
                raise ValueError(
                    "every prefill-pool replica needs prefill_only=True "
                    "— a replica that decodes locally never parks a "
                    "handoff")
        for e in decode_replicas:
            if getattr(e, "prefill_only", False):
                raise ValueError(
                    "decode-pool replicas must not be prefill_only — "
                    "the pool exists to run the decode (and re-prefill "
                    "fallback) work")
        if handoff_retry_ticks < 1:
            raise ValueError("handoff_retry_ticks must be >= 1")
        if ladder is not None and ladder.burn_source is None:
            ladder.burn_source = self._decode_burn
        self.ladder = ladder
        self.clock = clock
        self.channel = channel if channel is not None else KvChannel()
        self.handoff_retry_ticks = int(handoff_retry_ticks)
        reg = registry if registry is not None \
            else prefill_replicas[0].metrics.registry
        self.decode = FleetRouter(
            decode_replicas, clock=clock, injector=decode_injector,
            ladder=ladder, recorder=recorder, registry=reg,
            tracer=tracer, seed=seed + 1, **(decode_kw or {}))
        self.prefill = FleetRouter(
            prefill_replicas, clock=clock, injector=prefill_injector,
            ladder=ladder, recorder=recorder, registry=reg,
            tracer=tracer, seed=seed, **(prefill_kw or {}))
        self.recorder = recorder
        self._tick = 0
        self._buffered: List[_BufferedHandoff] = []
        self.handoffs = 0
        self.fallbacks = 0
        self.duplicate_responses = 0
        self._c_handoffs = reg.counter(
            "serving_disagg_handoffs_total",
            "KV handoffs installed on the decode pool")
        self._c_fallbacks = reg.counter(
            "serving_disagg_fallbacks_total",
            "handoffs that fell back to re-prefill on the decode pool")
        self._c_handoff_bytes = reg.counter(
            "serving_kv_handoff_bytes",
            "KV block bytes shipped prefill->decode, by cache kind",
            labelnames=("kind",))
        self._g_pending = reg.gauge(
            "serving_disagg_pending_handoffs",
            "handoffs buffered awaiting decode capacity")
        self._g_pending.set(0)

    # -- signals ---------------------------------------------------------

    def _decode_burn(self) -> float:
        """The decode pool's max SLO burn — the ladder's pressure
        signal in a disaggregated fleet (see the satellite fix note on
        :class:`~apex_tpu_torch.serving.DegradationLadder`)."""
        return max((self.decode._burn(e)
                    for _, e in self.decode._live()), default=0.0)

    def _prefill_burn(self) -> float:
        return max((self.prefill._burn(e)
                    for _, e in self.prefill._live()), default=0.0)

    # -- admission ---------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Place on the prefill pool (shared-ladder degradation gates
        apply — on the DECODE pool's burn).  Returns the prefill
        replica index, or -1 when parked for internal retry."""
        return self.prefill.submit(request)

    # -- the fleet tick ------------------------------------------------------

    def step(self) -> bool:
        """One disaggregated round: decode pool ticks first (a ladder
        escalation acts on decode replicas immediately), then the
        prefill pool (producing parked prefills), then the handoff
        pass ships every ready KV payload across the channel."""
        self._tick += 1
        busy_d = self.decode.step()
        busy_p = self.prefill.step()
        self._handoff_pass()
        self._g_pending.set(len(self._buffered))
        return busy_d or busy_p or bool(self._buffered)

    def run(self, max_steps: Optional[int] = None) -> List[Response]:
        """Drive :meth:`step` to drain (or ``max_steps``)."""
        steps = 0
        while True:
            busy = self.step()
            steps += 1
            if not busy and not any(
                    e._queue or e._active
                    for r in (self.prefill, self.decode)
                    for _, e in r._live()):
                break
            if max_steps is not None and steps >= max_steps:
                break
        return self.completed

    @property
    def pending(self) -> int:
        """Accepted-but-not-terminal count across both pools plus the
        handoff buffer (exactly-once sentinel: 0 on a drained fleet)."""
        return (self.prefill.pending + self.decode.pending
                + len(self._buffered))

    @property
    def completed(self) -> List[Response]:
        """Deduplicated responses across both pools."""
        out: Dict[object, Response] = {}
        for resp in self.prefill.completed + self.decode.completed:
            if resp.request_id in out:
                self.duplicate_responses += 1
                continue
            out[resp.request_id] = resp
        return list(out.values())

    # -- the handoff ---------------------------------------------------------

    def _handoff_pass(self) -> None:
        """Ship every parked prefill to the decode pool: harvest
        ``handoffs_ready()`` from HEALTHY prefill replicas (a crashed
        or suspect replica is unreachable — its parked work rides the
        fleet's death migration instead), move the blocks through the
        channel, install with ``adopt_kv``.  Buffered handoffs (decode
        pool momentarily full) retry for ``handoff_retry_ticks`` ticks
        before falling back to re-prefill."""
        now = self.clock()
        for i, eng in self.prefill._live():
            if self.prefill._state[i].health is not ReplicaHealth.HEALTHY:
                continue
            for _slot, rid in eng.handoffs_ready():
                handoff = eng.export_kv(rid)
                handoff.src_replica = i
                try:
                    handoff = self.channel.send_handoff(
                        handoff, step=self._tick,
                        edge=Edge(src=i, dst=-1))
                except DcnTimeout:
                    # handoff lost: the blocks never arrived, but the
                    # request + generated tokens are host state — the
                    # decode pool re-prefills them (token-bitwise, the
                    # fleet's standard migration)
                    self._fallback(handoff, now)
                    continue
                self._buffered.append(_BufferedHandoff(handoff))
        still: List[_BufferedHandoff] = []
        for buf in self._buffered:
            if self._install(buf.handoff, now):
                continue
            buf.ticks += 1
            if buf.ticks >= self.handoff_retry_ticks:
                self._fallback(buf.handoff, now)
            else:
                still.append(buf)
        self._buffered = still

    def _install(self, handoff: KvHandoff, now: float) -> bool:
        """One install attempt on the least-loaded healthy decode
        replica.  True when the handoff reached a terminal state
        (installed, preempted, or handed to the fallback); False to
        keep it buffered."""
        req = handoff.request
        rid = req.request_id
        target = self.decode._pick_target()
        if target is None:
            return False                 # no healthy decode replica yet
        eng = self.decode.replicas[target]
        if len(req.prompt) + len(handoff.generated) >= eng.max_seq:
            self.decode._router_finish(req, handoff.generated,
                                       "preempted")
            self.prefill._inflight.pop(rid, None)
            return True
        if req.trace is not None:
            # the next causal hop + the arrow-chain step that stitches
            # prefill-hop -> handoff -> decode-hop in one Perfetto chain
            req.trace.next_hop(replica=str(target))
            emit_flow(self.prefill._router_tracer(), req.trace,
                      "kv_handoff", request_id=rid,
                      src=handoff.src_replica, dst=target,
                      nbytes=handoff.nbytes(), kind=handoff.kind)
        try:
            eng.adopt_kv(handoff)
        except QueueFull:
            return False                 # retry next tick
        except ValueError:
            # storage-tag or context misfit: a bitwise install is
            # impossible, a re-prefill is not
            self._fallback(handoff, now)
            return True
        self.handoffs += 1
        self._c_handoffs.inc()
        self._c_handoff_bytes.inc(handoff.nbytes(), kind=handoff.kind)
        eng.trace.migrate(rid, handoff.src_replica, target)
        fl = self.prefill._inflight.pop(rid, None)
        self.decode._inflight[rid] = _InFlight(
            req, target, fl.submitted_t if fl is not None else now)
        self.decode._resume_watch[rid] = (target, len(handoff.generated))
        if self.recorder is not None:
            self.recorder.record("disagg", "kv_handoff", request_id=rid,
                                 src=handoff.src_replica, dst=target,
                                 nbytes=handoff.nbytes(),
                                 tick=self._tick)
        return True

    def _fallback(self, handoff: KvHandoff, now: float) -> None:
        """Re-prefill fallback: the decode pool adopts
        ``prompt + generated`` through the fleet's standard migration —
        no KV bytes needed, token-bitwise, merely slower."""
        rid = handoff.request.request_id
        self.fallbacks += 1
        self._c_fallbacks.inc()
        self.prefill._inflight.pop(rid, None)
        if self.recorder is not None:
            self.recorder.record("disagg", "handoff_fallback",
                                 request_id=rid,
                                 src=handoff.src_replica,
                                 tick=self._tick)
        self.decode._migrate(handoff.request, list(handoff.generated),
                             src=-1, now=now)
