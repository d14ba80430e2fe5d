"""Host-side span tracing -> Chrome trace-event JSON (Perfetto-loadable) —
port of ``apex_tpu/observability/spans.py``.

``torch.profiler`` traces the DEVICE; what it cannot see is the host-side
orchestration around it — admission loops, sampling, checkpoint
serialization, the train loop's data stalls.  :func:`span` records those
as wall-clock spans:

    with span("prefill"):
        logits, kv = prefill(params, tokens)

Spans nest per thread (a span closed out of order raises — the same
contract as ``profiling.range_push/pop``) and every span ALSO opens
:func:`apex_tpu_torch.utils.profiling.annotate` with the same name by
default — ``torch.profiler.record_function`` (and nvtx on the card) — so
the ops launched inside carry the name on the profiler's timeline, and
the collectives issued inside report it as their ``scope``
(:func:`~apex_tpu_torch.observability.comms.collective_stats`): the host
span in the Perfetto trace and the profiler's range share one vocabulary.

Events use the Chrome trace-event format (``ph: "X"`` complete events,
microsecond timestamps, pid/tid) — ``Tracer.save(path)`` writes a file
that chrome://tracing and https://ui.perfetto.dev open directly.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

from apex_tpu_torch.utils.profiling import annotate

# monotone instance counter: two Tracers in ONE process (an in-process
# test fleet) must still mint distinct id tags, so pid alone is not
# enough — see `Tracer.id_tag`
_INSTANCE_SEQ = itertools.count()


class Tracer:
    """Collects spans into a Chrome trace-event list.  Thread-safe;
    ``clock`` is injectable (seconds; default ``time.perf_counter``).

    ``id_tag`` namespaces this tracer's async-event ids so traces from
    several replicas merge without (cat, id) collisions: each replica's
    id counters used to restart at 0, and Perfetto folds same-id flows
    from different files onto one row.  The default tag is
    ``"<pid hex>.<instance #>"`` — unique across processes AND across
    tracers within one process.  Flow events (:meth:`flow`) are the one
    deliberate exception: their ids must MATCH across replicas (that is
    how a migrated request's fragments stitch), so they are never
    prefixed."""

    def __init__(self, clock=time.perf_counter, *,
                 id_tag: Optional[str] = None):
        self.clock = clock
        self.id_tag = (id_tag if id_tag is not None
                       else f"{os.getpid():x}.{next(_INSTANCE_SEQ)}")
        self._lock = threading.Lock()
        self._events: list = []
        self._local = threading.local()

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def depth(self) -> int:
        """Current span nesting depth on THIS thread."""
        return len(self._stack())

    @contextlib.contextmanager
    def span(self, name: str, device: bool = True, **args):
        """Time a host-side region.  ``device=True`` (default) also
        opens ``profiling.annotate(name)`` (``torch.profiler.
        record_function``) so the ops launched inside carry the same name
        on the profiler's timeline; ``args`` become the trace event's
        ``args`` payload."""
        stack = self._stack()
        stack.append(name)
        depth = len(stack)
        t0 = self.clock()
        cm = annotate(name) if device else contextlib.nullcontext()
        error = None
        try:
            with cm:
                yield
        except BaseException as e:
            # the span still closes (and the stack still pops) when the
            # body raises; the event records what detonated so the
            # trace shows WHERE the exception path spent its time
            error = type(e).__name__
            raise
        finally:
            dt = self.clock() - t0
            popped = stack.pop()
            if popped != name:            # pragma: no cover - defensive
                raise RuntimeError(
                    f"span nesting violated: closing {name!r}, "
                    f"top of stack is {popped!r}")
            ev = {"name": name, "ph": "X", "cat": "host",
                  "ts": t0 * 1e6, "dur": dt * 1e6,
                  "pid": os.getpid(), "tid": threading.get_ident()}
            if args or depth > 1 or error:
                ev["args"] = {**args, "depth": depth}
                if error:
                    ev["args"]["error"] = error
            with self._lock:
                self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (trace-event ``ph: "i"``) — step
        boundaries, rollbacks, admissions."""
        ev = {"name": name, "ph": "i", "cat": "host", "s": "t",
              "ts": self.clock() * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # -- async (per-flow) events ---------------------------------------------
    #
    # Host spans live on thread tracks; a REQUEST's lifecycle hops
    # threads and interleaves with other requests, so it gets a
    # nestable async track instead: Perfetto groups events sharing
    # (cat, id) onto one row per flow — one row per request.

    def async_span(self, name: str, id: object, ts: float, dur: float,
                   cat: str = "request", **args) -> None:
        """One closed async slice on flow ``(cat, id)``: a ``ph: "b"``
        / ``ph: "e"`` nestable pair at ``ts``..``ts + dur`` (seconds on
        this tracer's clock).  Emitted after the fact — the request
        tracer records raw timestamps on the hot path and materializes
        trace events once, at request completion."""
        ident = f"{self.id_tag}/{id}"
        pid = os.getpid()
        begin = {"name": name, "ph": "b", "cat": cat, "id": ident,
                 "ts": ts * 1e6, "pid": pid, "tid": pid}
        if args:
            begin["args"] = dict(args)
        end = {"name": name, "ph": "e", "cat": cat, "id": ident,
               "ts": (ts + dur) * 1e6, "pid": pid, "tid": pid}
        with self._lock:
            self._events.append(begin)
            self._events.append(end)

    def async_instant(self, name: str, id: object, ts: float,
                      cat: str = "request", **args) -> None:
        """A point event (``ph: "n"``) on flow ``(cat, id)`` — decode
        ticks, admission edges."""
        ev = {"name": name, "ph": "n", "cat": cat,
              "id": f"{self.id_tag}/{id}",
              "ts": ts * 1e6, "pid": os.getpid(), "tid": os.getpid()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # -- flow events (cross-replica causality) -------------------------------
    #
    # Chrome stitches flow events sharing (cat, name, id) into one
    # arrow chain across tracks — and, after a merge, across replicas.
    # Fixed cat/name ("reqflow"/"request") keep the stitch key down to
    # the id alone; the id is the fleet-wide trace id and is therefore
    # NOT namespaced by `id_tag` (matching across replicas is the
    # point).

    FLOW_CAT = "reqflow"
    FLOW_NAME = "request"

    def flow(self, ph: str, id: object, ts: Optional[float] = None,
             **args) -> dict:
        """One flow event: ``ph`` is ``"s"`` (start), ``"t"`` (step) or
        ``"f"`` (end).  ``ts`` is seconds on this tracer's clock
        (default: now).  Returns the event dict (callers stash the span
        id they put in ``args`` to parent the next hop)."""
        if ph not in ("s", "t", "f"):
            raise ValueError(f"flow ph must be s/t/f, got {ph!r}")
        pid = os.getpid()
        ev = {"name": self.FLOW_NAME, "ph": ph, "cat": self.FLOW_CAT,
              "id": str(id),
              "ts": (self.clock() if ts is None else ts) * 1e6,
              "pid": pid, "tid": pid}
        if ph == "f":
            ev["bp"] = "e"          # bind the arrow to the enclosing slice
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)
        return ev

    # -- export --------------------------------------------------------------

    @property
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []

    def to_json(self) -> str:
        """Chrome trace-event JSON (the ``traceEvents`` object form)."""
        return json.dumps({"traceEvents": self.events,
                           "displayTimeUnit": "ms"})

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
        return path


# module-level default tracer: `from apex_tpu_torch.observability import span`
# is the whole integration for most call sites
_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT


def span(name: str, device: bool = True, *,
         tracer: Optional[Tracer] = None, **args):
    """``with span("prefill"): ...`` on the default tracer (or an
    explicit one via ``tracer=``)."""
    return (tracer or _DEFAULT).span(name, device=device, **args)
