#!/usr/bin/env python
"""Open-loop load generator + chaos scenario suite for apex_tpu_torch
serving — port of ``tools/loadgen.py``.

Synthesizes serving traffic against paged engines behind a
:class:`~apex_tpu_torch.serving.Router` (``--rate``, open-loop Poisson
arrivals, bounded-Pareto prompt lengths, shared system prompts, client
backoff on sheds) and reports TTFT / TPOT / end-to-end percentiles,
throughput, per-outcome counts and the prefix-cache hit rate.

**Chaos scenarios** (``--scenario``): the stack becomes a
:class:`~apex_tpu_torch.serving.FleetRouter` on a
:class:`~apex_tpu_torch.serving.VirtualClock`, so fault timing, backoff and
SLO burn are deterministic on any host:

* ``steady`` — no faults, the fleet machinery alone;
* ``replica_kill`` — a replica crashes mid-burst (``--kill-tick``); its
  in-flight requests migrate and resume with the same tokens;
* ``slow_replica`` — one replica silently slows (``--slow-s``); the
  straggler detector marks it SUSPECT;
* ``diurnal`` — a sin²-modulated arrival rate;
* ``bursty`` — synchronized bursts driving overload, the degradation
  ladder, shedding with ``retry_after_s``, and client backoff;
* ``disagg_diurnal`` / ``disagg_longctx_fair`` / ``disagg_quant`` — a
  :class:`~apex_tpu_torch.serving.DisaggregatedFleet` (prefill pool +
  decode pool, the KV handoff between them) under a
  :class:`~apex_tpu_torch.resilience.PoolCapacityController`: a mid-day
  prefill→decode mix flip, multi-tenant fairness, and the int8 KV × int8
  weights stack.

Every scenario report carries the exactly-once ledger, per-outcome counts,
SLO attainment on the virtual clock, the fleet's health / fault logs, the
recovery timeline and the trace-continuity verdict.  The model flags are
``tools/loadgen.py``'s; ``--device`` (default ``cuda``) says where the
replicas run.  The reference's ``capacity_diurnal`` and
``autopilot_drift`` scenarios, which drive a trainer beside the fleet, are
not ported.

Usage::

    python tools/loadgen_torch.py --scenario replica_kill --replicas 3 --json
    python tools/loadgen_torch.py --device cpu --scenario bursty
    python tools/loadgen_torch.py --device cpu --scenario disagg_diurnal
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np    # noqa: E402
import torch          # noqa: E402

SCENARIOS = ("steady", "replica_kill", "slow_replica", "diurnal", "bursty",
             "disagg_diurnal", "disagg_longctx_fair", "disagg_quant")

DISAGG_SCENARIOS = ("disagg_diurnal", "disagg_longctx_fair",
                    "disagg_quant")

# scenarios that run the disagg_diurnal mixed-day workload (and its
# mid-day pool flip)
_DIURNAL_MIX = ("disagg_diurnal", "disagg_quant")


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def _build_model(args, model=None):
    """The replicas' shared model: ``model`` when given (its weights as
    they are), else a GPT of the flags' shape with random weights drawn
    from a generator seeded with 0, on ``--device``."""
    if model is not None:
        return model
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    wq = getattr(args, "weight_quant", None)
    cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                    num_layers=args.layers,
                    num_attention_heads=args.heads,
                    max_seq_len=args.max_seq,
                    weight_quant=None if wq in (None, "none") else wq)
    return GPTModel(cfg, device=_device(args)).init_params(
        torch.Generator().manual_seed(0))


def _device(args):
    return getattr(args, "device", "cuda")


def _build_replicas(args, model, clock, tracers=None):
    from apex_tpu_torch.observability.slo import SLOMonitor, SLOTarget
    from apex_tpu_torch.serving import PagedInferenceEngine, TickScheduler
    from apex_tpu_torch.utils.profiling import ServingMetrics

    replicas = []
    for i in range(args.replicas):
        slo = SLOMonitor([SLOTarget("ttft", args.ttft_slo_s,
                                    objective=0.9)], clock=clock)
        metrics = ServingMetrics(clock, slo=slo)
        replicas.append(PagedInferenceEngine(
            model, max_slots=args.max_slots,
            block_size=args.block_size,
            chunked_prefill=args.chunked,
            scheduler=TickScheduler(token_budget=args.token_budget),
            metrics=metrics, max_queue=args.max_queue, clock=clock,
            tracer=tracers[i] if tracers else None,
            device=model.device))
    return replicas


def build_stack(args, model=None):
    """(router, replicas): paged engines behind an SLO-aware router."""
    from apex_tpu_torch.serving import Router

    model = _build_model(args, model)
    replicas = _build_replicas(args, model, time.monotonic)
    router = Router(replicas, max_queue_depth=args.max_queue_depth,
                    burn_threshold=args.burn_threshold,
                    burn_window_s=args.burn_window_s)
    return router, replicas


def synthesize(args):
    """The workload: (arrival_time, Request) pairs, pre-generated so a
    run is reproducible from ``--seed`` alone."""
    from apex_tpu_torch.inference import Request

    rng = np.random.RandomState(args.seed)
    prefixes = [list(rng.randint(1, args.vocab,
                                 args.shared_prefix_len).astype(int))
                for _ in range(args.num_prefixes)]
    work, t = [], 0.0
    for i in range(args.requests):
        t += float(rng.exponential(1.0 / args.rate))
        # bounded Pareto: heavy tail, but it must fit the cache row
        tail = min(int(rng.pareto(args.pareto_shape) * args.min_prompt)
                   + args.min_prompt, args.max_seq - args.max_new - 1)
        toks = list(rng.randint(1, args.vocab, tail).astype(int))
        if rng.rand() < args.shared_prefix_prob:
            toks = (prefixes[rng.randint(args.num_prefixes)]
                    + toks)[:args.max_seq - args.max_new - 1]
        work.append((0.0 if args.overload else t,
                     Request(i, toks, max_new_tokens=args.max_new)))
    return work


def _outcome_counts(responses, shed_client: int) -> dict:
    out: dict = {}
    for rep in responses.values():
        out[rep.finish_reason] = out.get(rep.finish_reason, 0) + 1
    if shed_client:
        out["shed_client"] = shed_client
    return out


def run_loadgen(args, model=None) -> dict:
    from apex_tpu_torch.serving import RequestShed

    router, replicas = build_stack(args, model)
    work = synthesize(args)
    client_retries = int(getattr(args, "client_retries", 0))
    crng = np.random.RandomState(getattr(args, "seed", 0) + 1)
    placed: dict = {}                    # request_id -> replica index
    submit_t: dict = {}
    shed = 0
    retried = 0
    t0 = time.monotonic()
    # (arrival, tiebreak, request, retries_left) — the tiebreak keeps
    # bisect away from comparing Request objects
    pending = [(t, i, req, client_retries)
               for i, (t, req) in enumerate(work)]
    seq = len(pending)
    while pending or any(e._queue or e._active for e in replicas):
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            _, _, req, retries = pending.pop(0)
            submit_t.setdefault(req.request_id, time.monotonic())
            try:
                placed[req.request_id] = router.submit(req)
            except RequestShed as e:
                if retries > 0:
                    # honor the hint, jittered so backed-off clients
                    # return staggered instead of as a second burst
                    back = e.retry_after_s * (1.0 + 0.5 * crng.rand())
                    bisect.insort(pending,
                                  (now + back, seq, req, retries - 1))
                    seq += 1
                    retried += 1
                else:
                    shed += 1
        router.step()
    wall = time.monotonic() - t0

    done_t = time.monotonic()
    responses = {r.request_id: r for r in router.completed}
    e2e, tpots, tokens = [], [], 0
    for rid, rep in responses.items():
        # steady-state completions all land by the final step; the
        # residual after-loop skew is bounded by one engine tick
        e2e.append(done_t - submit_t[rid]
                   if rid in submit_t else 0.0)
        tokens += len(rep.tokens)
        eng = replicas[placed[rid]]
        ttft = eng.metrics.ttft.get(rid)
        if ttft is not None and len(rep.tokens) > 1:
            tpots.append((e2e[-1] - ttft) / (len(rep.tokens) - 1))
    ttfts = [t for e in replicas for t in e.metrics.ttft.values()]
    hit = lookup = 0
    for e in replicas:
        hit += e.pool.prefix_hit_tokens
        lookup += e.pool.prefix_lookup_tokens
    report = {
        "requests": args.requests,
        "served": len(responses),
        "shed": shed,
        "shed_fraction": shed / args.requests if args.requests else 0.0,
        "client_retries": retried,
        "outcomes": _outcome_counts(responses, shed),
        "wall_s": wall,
        "tokens": tokens,
        "throughput_tok_s": tokens / wall if wall else 0.0,
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p90_s": _pct(ttfts, 90),
        "ttft_p99_s": _pct(ttfts, 99),
        "tpot_p50_s": _pct(tpots, 50),
        "tpot_p90_s": _pct(tpots, 90),
        "e2e_p50_s": _pct(e2e, 50),
        "e2e_p99_s": _pct(e2e, 99),
        "prefix_hit_rate": hit / lookup if lookup else 0.0,
        "replicas": [{"served": sum(1 for v in placed.values() if v == i),
                      "pool": e.pool.stats()}
                     for i, e in enumerate(replicas)],
    }
    return report


# -- chaos scenarios ---------------------------------------------------------


def _scenario_injector(args):
    from apex_tpu_torch.serving import ServingFault, ServingFaultInjector

    s = args.scenario
    if s == "replica_kill":
        return ServingFaultInjector([ServingFault(
            args.kill_tick, args.kill_replica % args.replicas,
            "replica_crash", duration=args.kill_duration)])
    if s == "slow_replica":
        return ServingFaultInjector([ServingFault(
            args.slow_tick, 1 % args.replicas, "slow_replica",
            magnitude=args.slow_s, duration=args.slow_duration)])
    return None     # steady / diurnal / bursty shape the LOAD, not faults


def synthesize_scenario(args):
    """Virtual-time arrivals per scenario + the usual heavy-tail
    prompts; reproducible from ``--seed`` alone."""
    from apex_tpu_torch.inference import Request

    rng = np.random.RandomState(args.seed)
    prefixes = [list(rng.randint(1, args.vocab,
                                 args.shared_prefix_len).astype(int))
                for _ in range(args.num_prefixes)]
    n = args.requests
    times = []
    if args.scenario == "bursty":
        t = 0.0
        while len(times) < n:
            times.extend([t] * min(args.burst_n, n - len(times)))
            t += args.burst_gap_s
    elif args.scenario in ("diurnal", "capacity_diurnal",
                           "autopilot_drift"):
        # thinning: candidate arrivals at the peak rate, accepted with
        # probability rate(t)/peak where rate(t) ~ sin^2 over --period-s
        t = 0.0
        while len(times) < n:
            t += float(rng.exponential(1.0 / args.rate))
            frac = 0.1 + 0.9 * float(
                np.sin(np.pi * t / args.period_s) ** 2)
            if rng.rand() < frac:
                times.append(t)
    else:
        t = 0.0
        for _ in range(n):
            t += float(rng.exponential(1.0 / args.rate))
            times.append(t)
    work = []
    for i, t in enumerate(times):
        tail = min(int(rng.pareto(args.pareto_shape) * args.min_prompt)
                   + args.min_prompt, args.max_seq - args.max_new - 1)
        toks = list(rng.randint(1, args.vocab, tail).astype(int))
        if rng.rand() < args.shared_prefix_prob:
            toks = (prefixes[rng.randint(args.num_prefixes)]
                    + toks)[:args.max_seq - args.max_new - 1]
        work.append((t, Request(i, toks, max_new_tokens=args.max_new,
                                seed=i)))
    return work


def build_fleet(args, clock, model=None):
    """(fleet, replicas, injector): the fault-tolerant stack on an
    injectable clock, fully traced — one Tracer per replica plus a
    router lane, so every scenario run can assert flow-chain
    continuity over the merged timeline, and a FlightRecorder so
    replica deaths / ladder escalations cut correlated snapshots.
    ``args.trace = False`` builds it without tracers (the tracers' host
    cost is then what a traced run adds)."""
    from apex_tpu_torch.observability import FlightRecorder, Tracer
    from apex_tpu_torch.serving import DegradationLadder, FleetRouter

    model = _build_model(args, model)
    traced = getattr(args, "trace", True)
    tracers = [Tracer(clock=clock, id_tag=f"r{i}") if traced else None
               for i in range(args.replicas)]
    replicas = _build_replicas(args, model, clock, tracers=tracers)
    injector = _scenario_injector(args)
    ladder = DegradationLadder(
        thresholds=(args.burn_threshold / 7.2, args.burn_threshold / 2.4,
                    args.burn_threshold),
        step_down_s=args.ladder_step_down_s)
    fleet = FleetRouter(
        replicas, injector=injector, clock=clock,
        max_queue_depth=args.max_queue_depth,
        burn_threshold=args.burn_threshold,
        burn_window_s=args.burn_window_s,
        retry_budget=args.retry_budget,
        hedge_after_s=args.hedge_after_s,
        ladder=ladder, seed=args.seed,
        tracer=Tracer(clock=clock, id_tag="router") if traced else None,
        recorder=FlightRecorder(clock=clock))
    return fleet, replicas, injector


def fleet_collector(fleet, replicas):
    """A :class:`FleetCollector` over the stack's tracers (router lane
    first, then one per replica)."""
    from apex_tpu_torch.observability import FleetCollector

    fc = FleetCollector()
    fc.add_replica("router", tracer=fleet.tracer)
    for i, e in enumerate(replicas):
        fc.add_replica(f"r{i}", tracer=e.trace.tracer)
    return fc


def run_scenario(args, model=None, stack=None) -> dict:
    """Drive one chaos scenario on the virtual clock; returns the
    asserting-ready report (exactly-once ledger, SLO attainment,
    health/fault logs, recovery timeline, and ``shed_reasons``: the
    :class:`ShedReason` values of the sheds the client saw, by count).
    ``model`` serves instead of a fresh one; a dict passed as ``stack``
    receives the ``clock``, ``fleet`` and ``replicas`` the run used."""
    from apex_tpu_torch.serving import (RequestShed, ShedReason,
                                        VirtualClock)

    clock = VirtualClock()
    fleet, replicas, injector = build_fleet(args, clock, model)
    if stack is not None:
        stack.update(clock=clock, fleet=fleet, replicas=replicas)
    work = synthesize_scenario(args)
    crng = np.random.RandomState(args.seed + 1)
    pending = [(t, i, req, int(args.client_retries))
               for i, (t, req) in enumerate(work)]
    seq = len(pending)
    submit_t: dict = {}
    finish_t: dict = {}
    submitted: set = set()
    shed_client: dict = {}               # request_id -> final shed reason
    shed_reasons: dict = {}              # ShedReason value -> sheds seen
    ticks = 0
    seen = 0
    degraded_max = 0
    while True:
        now = clock()
        while pending and pending[0][0] <= now:
            _, _, req, retries = pending.pop(0)
            try:
                fleet.submit(req)
                submitted.add(req.request_id)
                submit_t.setdefault(req.request_id, now)
                shed_client.pop(req.request_id, None)
            except RequestShed as e:
                key = e.reason.value if isinstance(
                    e.reason, ShedReason) else None
                shed_reasons[key] = shed_reasons.get(key, 0) + 1
                if retries > 0:
                    back = e.retry_after_s * (1.0 + 0.5 * crng.rand())
                    bisect.insort(pending,
                                  (now + back, seq, req, retries - 1))
                    seq += 1
                else:
                    shed_client[req.request_id] = e.reason.value
        busy = fleet.step()
        clock.advance(args.tick_s)
        ticks += 1
        if fleet.ladder is not None:
            degraded_max = max(degraded_max, fleet.ladder.level)
        done = fleet.completed
        while seen < len(done):
            finish_t[done[seen].request_id] = clock()
            seen += 1
        if not pending and not busy \
                and not any(e._queue or e._active for e in replicas):
            break
        if ticks >= args.max_ticks:
            break
    responses = {r.request_id: r for r in fleet.completed}
    dup_client = sum(1 for _ in fleet.completed) - len(responses)
    lost = sorted(submitted - set(responses))
    e2e_ok = [finish_t[rid] - submit_t[rid] for rid, rep in
              responses.items()
              if rep.finish_reason in ("eos", "length")
              and rid in finish_t and rid in submit_t]
    attainment = (sum(1 for v in e2e_ok if v <= args.e2e_slo_s)
                  / len(e2e_ok)) if e2e_ok else 0.0
    ttfts = [t for e in replicas for t in e.metrics.ttft.values()]
    tokens = sum(len(r.tokens) for r in responses.values())
    cont = fleet_collector(fleet, replicas).continuity()
    return {
        "scenario": args.scenario,
        "requests": args.requests,
        "submitted": len(submitted),
        "responses": len(responses),
        "lost": lost,
        "duplicated": dup_client,
        "engine_duplicates_suppressed": fleet.duplicate_responses,
        "shed_client": len(shed_client),
        "outcomes": _outcome_counts(responses, len(shed_client)),
        "fleet_pending": fleet.pending,
        "ticks": ticks,
        "virtual_s": clock(),
        "tokens": tokens,
        "e2e_served": len(e2e_ok),
        "e2e_p50_s": _pct(e2e_ok, 50),
        "e2e_p99_s": _pct(e2e_ok, 99),
        "slo_attainment": attainment,
        "ttft_p50_s": _pct(ttfts, 50),
        "retries": fleet.retries,
        "hedges": fleet.hedges,
        "migrations": fleet.migrations,
        "degraded_max_level": degraded_max,
        "health_log": list(fleet.health_log),
        "fault_log": list(injector.log) if injector is not None else [],
        "recovery": fleet.recovery_report(),
        "trace_continuity": {
            "chains": len(cont["chains"]),
            "complete": len(cont["complete"]),
            "broken": cont["broken"],
            "orphans": cont["orphans"],
            "migrated_chains": sorted(
                tid for tid, c in cont["chains"].items()
                if c["migrated"]),
        },
        "flight_snapshots": len(fleet.recorder.dumps),
        "shed_reasons": shed_reasons,
    }


# -- disaggregated scenarios --------------------------------------------------


def build_disagg_fleet(args, clock, model=None):
    """(fleet, controller): a 2-pool DisaggregatedFleet (prefill pool of
    ``prefill_only`` chunked engines, decode pool of ordinary ones, same
    cache kind on both sides so handoffs install bitwise) under a
    :class:`PoolCapacityController` sizing the pools on TTFT-burn vs
    TPOT-burn.  Fully traced for flow-chain continuity assertions."""
    from apex_tpu_torch.observability import FlightRecorder, Tracer
    from apex_tpu_torch.observability.slo import SLOMonitor, SLOTarget
    from apex_tpu_torch.resilience import PoolCapacityController
    from apex_tpu_torch.serving import (DegradationLadder, DisaggregatedFleet,
                                  KvChannel, PagedInferenceEngine,
                                  TickScheduler)
    from apex_tpu_torch.utils.profiling import ServingMetrics

    model = _build_model(args, model)
    kv_quant = None if args.kv_quant in (None, "none") else args.kv_quant

    def engine(prefill_only, tracer=None):
        slo = SLOMonitor(
            [SLOTarget("ttft", args.ttft_slo_s, objective=0.9),
             SLOTarget("token_latency", args.tpot_slo_s, objective=0.9)],
            clock=clock)
        return PagedInferenceEngine(
            model, max_slots=args.max_slots,
            block_size=args.block_size, chunked_prefill=True,
            prefill_only=prefill_only, kv_quant=kv_quant,
            scheduler=TickScheduler(token_budget=args.token_budget),
            metrics=ServingMetrics(clock, slo=slo),
            max_queue=args.max_queue, clock=clock, tracer=tracer,
            device=model.device)

    tracers = {f"p{i}": Tracer(clock=clock, id_tag=f"p{i}")
               for i in range(args.prefill_replicas)}
    tracers.update({f"d{i}": Tracer(clock=clock, id_tag=f"d{i}")
                    for i in range(args.decode_replicas)})
    prefill = [engine(True, tracers[f"p{i}"])
               for i in range(args.prefill_replicas)]
    decode = [engine(False, tracers[f"d{i}"])
              for i in range(args.decode_replicas)]
    ladder = DegradationLadder(
        thresholds=(args.burn_threshold / 7.2, args.burn_threshold / 2.4,
                    args.burn_threshold),
        step_down_s=args.ladder_step_down_s)
    fleet = DisaggregatedFleet(
        prefill, decode, clock=clock, channel=KvChannel(),
        ladder=ladder, seed=args.seed,
        recorder=FlightRecorder(clock=clock),
        tracer=Tracer(clock=clock, id_tag="router"),
        prefill_kw=dict(max_queue_depth=args.max_queue_depth,
                        burn_threshold=args.burn_threshold,
                        burn_window_s=args.burn_window_s,
                        retry_budget=args.retry_budget),
        decode_kw=dict(max_queue_depth=args.max_queue_depth,
                       burn_threshold=args.burn_threshold,
                       burn_window_s=args.burn_window_s,
                       retry_budget=args.retry_budget))
    def factory(pool):
        # a shifted-in replica traces like the original ones, or the
        # continuity gate would see its finishes vanish mid-chain
        tag = f"{pool[0]}x{len(tracers)}"
        tracers[tag] = Tracer(clock=clock, id_tag=tag)
        return engine(pool == "prefill", tracers[tag])

    controller = PoolCapacityController(
        {"prefill": fleet.prefill, "decode": fleet.decode}, factory,
        burn_high=args.burn_threshold, burn_low=1.0,
        burn_window_s=args.burn_window_s,
        confirm_ticks=3, cooldown_s=2.0, clock=clock)
    fleet._tracers = tracers            # for the continuity collector
    return fleet, controller


def synthesize_disagg(args):
    """(arrival, Request, tag) triples for the disagg scenarios.

    ``disagg_diurnal``: the first half of the workload is
    ``prefill_heavy`` (prompts ~4× the baseline, generations ~¼), the
    second half ``decode_heavy`` (short prompts, full-length
    generations) — the mid-day mix flip the pool controller reacts to.
    ``disagg_longctx_fair``: ``--tenants`` round-robin tenants; tenant
    0 submits near-context-limit prompts, the rest short interactive
    ones."""
    from apex_tpu_torch.inference import Request

    rng = np.random.RandomState(args.seed)
    n = args.requests
    work, t = [], 0.0
    cap = args.max_seq - args.max_new - 1
    for i in range(n):
        t += float(rng.exponential(1.0 / args.rate))
        if args.scenario in _DIURNAL_MIX:
            heavy = i < n // 2
            tag = "prefill_heavy" if heavy else "decode_heavy"
            base = args.min_prompt * 4 if heavy else args.min_prompt
            new = max(2, args.max_new // 4) if heavy else args.max_new
            tail = min(int(rng.pareto(args.pareto_shape) * base) + base,
                       args.max_seq - new - 1)
        else:
            tenant = i % args.tenants
            tag = f"tenant{tenant}"
            new = args.max_new
            if tenant == 0:             # the long-context tenant
                tail = cap - int(rng.randint(0, max(1, cap // 8)))
                tail = min(tail, args.max_seq - new - 1)
            else:
                tail = min(int(rng.pareto(args.pareto_shape)
                               * args.min_prompt) + args.min_prompt,
                           args.max_seq - new - 1)
        toks = list(rng.randint(1, args.vocab, tail).astype(int))
        work.append((t, Request(i, toks, max_new_tokens=new, seed=i),
                     tag))
    return work


def run_disagg_scenario(args, model=None) -> dict:
    """Drive one disaggregated scenario on the virtual clock.  The
    report carries the exactly-once ledger, per-phase (or per-tenant)
    SLO attainment, the handoff ledger, the capacity audit, and a
    ``gates`` dict the CI legs assert every value of.  ``model`` serves
    instead of a fresh one (``disagg_quant`` needs its config to say
    ``weight_quant="int8"``)."""
    from apex_tpu_torch.observability import FleetCollector
    from apex_tpu_torch.serving import RequestShed, VirtualClock

    if args.scenario == "disagg_quant":
        # the fully-quantized serving arm: int8 decode weights x int8
        # KV blocks over the same mixed day as disagg_diurnal
        args.kv_quant = "int8"
        args.weight_quant = "int8"
    clock = VirtualClock()
    fleet, controller = build_disagg_fleet(args, clock, model)
    work = synthesize_disagg(args)
    tags = {req.request_id: tag for _, req, tag in work}
    mid_t = work[len(work) // 2][0]
    crng = np.random.RandomState(args.seed + 1)
    pending = [(t, i, req, int(args.client_retries))
               for i, (t, req, _) in enumerate(work)]
    seq = len(pending)
    submit_t: dict = {}
    finish_t: dict = {}
    submitted: set = set()
    shed_client: dict = {}
    ticks = seen = 0
    shift_requested = False
    while True:
        now = clock()
        if args.scenario in _DIURNAL_MIX and not shift_requested \
                and now >= mid_t:
            # the mid-day flip: decode-heavy afternoon needs the chip
            # more than the now-quiet prefill pool does
            controller.request_shift("to_decode")
            shift_requested = True
        while pending and pending[0][0] <= now:
            _, _, req, retries = pending.pop(0)
            try:
                fleet.submit(req)
                submitted.add(req.request_id)
                submit_t.setdefault(req.request_id, now)
                shed_client.pop(req.request_id, None)
            except RequestShed as e:
                if retries > 0:
                    back = e.retry_after_s * (1.0 + 0.5 * crng.rand())
                    bisect.insort(pending,
                                  (now + back, seq, req, retries - 1))
                    seq += 1
                else:
                    shed_client[req.request_id] = e.reason.value
        busy = fleet.step()
        controller.tick()
        clock.advance(args.tick_s)
        ticks += 1
        done = fleet.completed
        while seen < len(done):
            finish_t[done[seen].request_id] = clock()
            seen += 1
        if not pending and not busy and fleet.pending == 0 \
                and not controller.shifting:
            break
        if ticks >= args.max_ticks:
            break
    responses = {r.request_id: r for r in fleet.completed}
    lost = sorted(submitted - set(responses))
    per_phase: dict = {}
    for rid, rep in responses.items():
        if rep.finish_reason not in ("eos", "length") \
                or rid not in finish_t or rid not in submit_t:
            continue
        per_phase.setdefault(tags[rid], []).append(
            finish_t[rid] - submit_t[rid])
    attainment = {
        tag: sum(1 for v in xs if v <= args.e2e_slo_s) / len(xs)
        for tag, xs in sorted(per_phase.items())}
    fc = FleetCollector()
    fc.add_replica("router", tracer=fleet.prefill.tracer)
    for name, tr in fleet._tracers.items():
        fc.add_replica(name, tracer=tr)
    cont = fc.continuity()
    audit = controller.audit()
    gates = {
        "exactly_once": not lost and fleet.duplicate_responses == 0
        and fleet.pending == 0,
        "slo_attainment": bool(attainment)
        and all(a >= 0.9 for a in attainment.values()),
        "capacity_audit_clean": audit == [],
        "no_broken_chains": not cont["broken"],
    }
    return {
        "scenario": args.scenario,
        "requests": args.requests,
        "submitted": len(submitted),
        "responses": len(responses),
        "lost": lost,
        "duplicated": fleet.duplicate_responses,
        "shed_client": len(shed_client),
        "outcomes": _outcome_counts(responses, len(shed_client)),
        "fleet_pending": fleet.pending,
        "ticks": ticks,
        "virtual_s": clock(),
        "tokens": sum(len(r.tokens) for r in responses.values()),
        "slo_attainment": attainment,
        "handoffs": fleet.handoffs,
        "fallbacks": fleet.fallbacks,
        "handoff_bytes": fleet.channel.handoff_bytes,
        "weight_bytes_per_replica":
            fleet.decode.replicas[0].weight_bytes,
        "pool_split": controller.split,
        "pool_shifts": controller.stats["shifts"],
        "capacity_audit": audit,
        "trace_continuity": {
            "chains": len(cont["chains"]),
            "complete": len(cont["complete"]),
            "broken": cont["broken"],
            "orphans": cont["orphans"],
        },
        "gates": gates,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--overload", action="store_true",
                    help="submit everything as one burst (forces "
                    "deterministic shedding)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-queue-depth", type=int, default=8,
                    help="router admission bound per replica")
    ap.add_argument("--burn-threshold", type=float, default=14.4)
    ap.add_argument("--burn-window-s", type=float, default=60.0)
    ap.add_argument("--ttft-slo-s", type=float, default=0.5)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill via the tick scheduler")
    ap.add_argument("--token-budget", type=int, default=64)
    ap.add_argument("--client-retries", type=int, default=3,
                    help="client resubmits a shed request up to N times, "
                    "honoring its retry_after_s with jitter (0: drop)")
    # chaos scenarios (FleetRouter on a virtual clock)
    ap.add_argument("--scenario", choices=SCENARIOS, default=None,
                    help="run a fleet chaos scenario instead of the "
                    "wall-clock loadgen")
    ap.add_argument("--tick-s", type=float, default=0.02,
                    help="virtual seconds per fleet tick")
    ap.add_argument("--e2e-slo-s", type=float, default=3.0,
                    help="end-to-end SLO asserted by the scenarios "
                    "(virtual seconds)")
    ap.add_argument("--max-ticks", type=int, default=5000)
    ap.add_argument("--retry-budget", type=int, default=4)
    ap.add_argument("--hedge-after-s", type=float, default=None,
                    help="hedge a first-token-less request after this "
                    "many (virtual) seconds; default: no hedging")
    ap.add_argument("--ladder-step-down-s", type=float, default=0.5)
    ap.add_argument("--kill-tick", type=int, default=6)
    ap.add_argument("--kill-replica", type=int, default=1)
    ap.add_argument("--kill-duration", type=int, default=10 ** 6,
                    help="crash length in ticks (default: permanent)")
    ap.add_argument("--slow-tick", type=int, default=4)
    ap.add_argument("--slow-s", type=float, default=0.1,
                    help="extra virtual seconds per tick on the slow "
                    "replica")
    ap.add_argument("--slow-duration", type=int, default=40)
    ap.add_argument("--burst-n", type=int, default=8)
    ap.add_argument("--burst-gap-s", type=float, default=0.5)
    ap.add_argument("--period-s", type=float, default=4.0,
                    help="diurnal modulation period (virtual seconds)")
    # disaggregated scenarios
    ap.add_argument("--prefill-replicas", type=int, default=2)
    ap.add_argument("--decode-replicas", type=int, default=2)
    ap.add_argument("--weight-quant", choices=("none", "int8"),
                    default="none",
                    help="int8 decode weights (GPTConfig.weight_quant); "
                         "disagg_quant forces int8")
    ap.add_argument("--kv-quant", choices=("none", "int8"),
                    default="none",
                    help="decode+prefill pool KV cache storage")
    ap.add_argument("--tpot-slo-s", type=float, default=0.5)
    ap.add_argument("--tenants", type=int, default=3,
                    help="round-robin tenants for disagg_longctx_fair "
                    "(tenant 0 is the long-context one)")
    # workload shape
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--pareto-shape", type=float, default=2.5)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--shared-prefix-prob", type=float, default=0.5)
    ap.add_argument("--shared-prefix-len", type=int, default=16)
    ap.add_argument("--num-prefixes", type=int, default=2)
    # model shape (small defaults: the loadgen measures the SERVING
    # layer; model quality is irrelevant to scheduling behavior)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the replicas run (cpu for "
                    "the plain PyTorch versions of the kernels)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.scenario in DISAGG_SCENARIOS:
        report = run_disagg_scenario(args)
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            print(f"scenario {report['scenario']}: "
                  f"{report['responses']}/{report['submitted']} answered "
                  f"(lost {len(report['lost'])}, "
                  f"dup {report['duplicated']}) in {report['ticks']} "
                  f"ticks / {report['virtual_s']:.2f}s virtual")
            print(f"  outcomes {report['outcomes']}")
            print(f"  handoffs {report['handoffs']}  "
                  f"fallbacks {report['fallbacks']}  "
                  f"bytes {report['handoff_bytes']}")
            print(f"  pool split {report['pool_split']}  "
                  f"shifts {report['pool_shifts']}  "
                  f"audit {report['capacity_audit']}")
            for tag, a in report["slo_attainment"].items():
                print(f"  slo[{tag}] {a:.0%}")
            print(f"  gates {report['gates']}")
        return 0 if all(report["gates"].values()) else 1

    if args.scenario is not None:
        report = run_scenario(args)
        if args.json:
            print(json.dumps(report, indent=2))
            return 0
        print(f"scenario {report['scenario']}: "
              f"{report['responses']}/{report['submitted']} answered "
              f"(lost {len(report['lost'])}, dup {report['duplicated']}, "
              f"client-shed {report['shed_client']}) "
              f"in {report['ticks']} ticks / {report['virtual_s']:.2f}s "
              "virtual")
        print(f"  outcomes {report['outcomes']}")
        print(f"  slo attainment {report['slo_attainment']:.0%} "
              f"(e2e p50 {report['e2e_p50_s'] * 1e3:.0f} ms, "
              f"p99 {report['e2e_p99_s'] * 1e3:.0f} ms vs "
              f"{args.e2e_slo_s:.1f}s)")
        print(f"  retries {report['retries']}  hedges {report['hedges']}  "
              f"migrations {report['migrations']}  "
              f"degraded<= {report['degraded_max_level']}")
        if report["health_log"]:
            print(f"  health transitions {report['health_log']}")
        tc = report["trace_continuity"]
        print(f"  trace continuity: {tc['complete']}/{tc['chains']} "
              f"chains complete, {len(tc['broken'])} broken, "
              f"{len(tc['orphans'])} orphans, "
              f"{len(tc['migrated_chains'])} migrated; "
              f"{report['flight_snapshots']} flight snapshot(s)")
        rec = report["recovery"]
        if rec["first_dead"]:
            print(f"  recovery: dead@{rec['first_dead']}  "
                  f"migrated@{rec['first_migration']}  "
                  f"resumed@{rec['first_resumed_token']}")
        return 0

    report = run_loadgen(args)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    print(f"served {report['served']}/{report['requests']} "
          f"(shed {report['shed']}, "
          f"{report['shed_fraction']:.0%}) in {report['wall_s']:.2f}s "
          f"-> {report['throughput_tok_s']:.0f} tok/s")
    print(f"  outcomes {report['outcomes']}  "
          f"client retries {report['client_retries']}")
    print(f"  ttft  p50 {report['ttft_p50_s'] * 1e3:8.1f} ms   "
          f"p90 {report['ttft_p90_s'] * 1e3:8.1f} ms   "
          f"p99 {report['ttft_p99_s'] * 1e3:8.1f} ms")
    print(f"  tpot  p50 {report['tpot_p50_s'] * 1e3:8.1f} ms   "
          f"p90 {report['tpot_p90_s'] * 1e3:8.1f} ms")
    print(f"  e2e   p50 {report['e2e_p50_s'] * 1e3:8.1f} ms   "
          f"p99 {report['e2e_p99_s'] * 1e3:8.1f} ms")
    print(f"  prefix-cache hit rate {report['prefix_hit_rate']:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
