"""Probe the ring collectives over torch.distributed and fit a machine cost
profile — the port of ``tools/comms_probe.py``:

    python3 tools/comms_probe_torch.py [--world N] [--out profile.json]
        [--ops psum,all_gather,...] [--dtypes f32,bf16,int8]
        [--sizes 4096,...] [--groups 2,4] [--backend nccl|gloo]
    python3 tools/comms_probe_torch.py --check profile.json [--max-age-s S]

Spawns ``--world`` ranks (default every card; NCCL, one rank a card, or
``--backend gloo`` on the CPU), microbenchmarks ``all_reduce`` /
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` / a one-hop
``batch_isend_irecv`` ring (the JAX names ``psum`` / ``all_gather`` /
``psum_scatter`` / ``ppermute``) across per-rank message sizes, ring sizes
(2, 4, 8 where they divide the world) and dtypes with
:func:`apex_tpu_torch.observability.costmodel.probe_collectives`, fits
per-(op, dtype) alpha-beta ring coefficients by least squares on all but a
held-out split, validates the fit on the held-out points (every third by
size within each curve: ``--holdout``), and writes the VERSIONED
machine-profile JSON — the same document the JAX package reads and
writes.  The probed points are tagged ``--link-class`` (``ici``, the
card-to-card fabric: NVLink between the cards of one machine);
``--simulate-dcn alpha,beta`` adds an exact synthetic ``dcn`` curve (the
network between machines, which one machine cannot probe).  ``--check``
re-validates a saved profile against its stored measurements (and its
staleness against ``--max-age-s``) without probing.

The last lines are the first card's name and power limit (``nvidia-smi``)
and one ``{json}`` line with every fitted curve, the hold-out report and the
seconds taken; the process exits non-zero when the hold-out's worst
predicted/measured ratio passes ``--tolerance``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import pickle
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _csv(cast):
    return lambda s: [cast(v) for v in s.split(",") if v]


def _rank(rank, world, out_dir, backend, kw):
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.observability.costmodel import probe_collectives
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{pathlib.Path(out_dir).resolve()}"
        "/store", rank=rank, world_size=world)
    t0 = time.perf_counter()
    ms = probe_collectives(**kw)
    seconds = time.perf_counter() - t0
    if rank == 0:
        with open(pathlib.Path(out_dir) / "probe.pkl", "wb") as f:
            pickle.dump(dict(measurements=[m.to_dict() for m in ms],
                             seconds=seconds), f)
    dist.barrier()
    dist.destroy_process_group()


def probe(world, backend, kw, out_dir):
    """Run the probe on ``world`` spawned ranks; returns rank 0's
    measurements (every rank returns the same) and the probe's seconds."""
    import torch.multiprocessing as mp
    from apex_tpu_torch.observability.costmodel import Measurement
    out_dir = pathlib.Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mp.start_processes(_rank, args=(world, str(out_dir), backend, kw),
                       nprocs=world, start_method="spawn", join=True)
    with open(out_dir / "probe.pkl", "rb") as f:
        got = pickle.load(f)
    return ([Measurement.from_dict(d) for d in got["measurements"]],
            got["seconds"])


def check(path, tolerance, max_age_s):
    from apex_tpu_torch.observability.costmodel import load_profile
    model, ms = load_profile(path)
    if not ms:
        print("profile carries no raw measurements; nothing to re-validate",
              file=sys.stderr)
        return 2
    report = model.validate(ms, tolerance=tolerance)
    out = {k: v for k, v in report.items() if k != "rows"}
    age = model.profile_age()
    out["profile_age_s"] = age
    out["n_measurements"] = model.meta.get("n_measurements")
    if max_age_s is not None:
        out["stale"] = model.is_stale(max_age_s)
        out["max_age_s"] = max_age_s
    print(json.dumps(out, indent=1))
    if max_age_s is not None and out["stale"]:
        reason = ("no probe stamp (never probed)" if age is None
                  else f"probed {age:.0f}s ago")
        print(f"profile is stale: {reason} (gate {max_age_s:.0f}s)",
              file=sys.stderr)
        return 1
    return 0 if report["within_tolerance"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "comms_profile.json"),
                    help="machine-profile JSON path")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--ops", type=_csv(str), default=None,
                    help="comma list from psum,all_gather,psum_scatter,"
                         "ppermute (default: all)")
    ap.add_argument("--dtypes", type=_csv(str),
                    default=["f32", "bf16", "int8"])
    ap.add_argument("--sizes", type=_csv(int), default=None,
                    help="per-rank local buffer bytes (default 4K..64M "
                         "powers of 4: up to past DDP's and ZeRO's 10 MB "
                         "buckets, into NVLink's bandwidth regime)")
    ap.add_argument("--groups", type=_csv(int), default=None,
                    help="ring sizes (default: 2,4,8 where they divide "
                         "the world)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--holdout", type=int, default=3,
                    help="hold out every Nth point per curve for "
                         "validation (0: fit on everything)")
    ap.add_argument("--tolerance", type=float, default=2.0,
                    help="validation gate on held-out pred/meas ratio")
    ap.add_argument("--check", metavar="PROFILE", default=None,
                    help="skip probing; re-validate PROFILE against its "
                         "stored measurements")
    ap.add_argument("--max-age-s", type=float, default=None,
                    help="with --check: also fail when the probe stamp is "
                         "older than this or missing")
    ap.add_argument("--link-class", default="ici",
                    help="fabric tag for the probed measurements")
    ap.add_argument("--simulate-dcn", metavar="ALPHA,BETA", default=None,
                    help="also inject a synthetic dcn curve with the given "
                         "per-hop latency (s) and inverse bandwidth "
                         "(s/byte), e.g. 1e-3,1e-8")
    args = ap.parse_args(argv)
    if args.check:
        return check(args.check, args.tolerance, args.max_age_s)

    simulate_dcn = None
    if args.simulate_dcn is not None:
        parts = [p for p in args.simulate_dcn.split(",") if p]
        if len(parts) != 2:
            ap.error("--simulate-dcn wants 'alpha,beta' (seconds, "
                     "seconds/byte), e.g. 1e-3,1e-8")
        simulate_dcn = (float(parts[0]), float(parts[1]))

    import torch
    from apex_tpu_torch.observability.costmodel import (
        COLLECTIVE_OPS, fit_cost_model, holdout_split,
        simulate_link_measurements)
    nccl = args.backend == "nccl"
    if nccl and not torch.cuda.is_available():
        print("--backend nccl needs NVIDIA GPUs (use --backend gloo on the "
              "CPU)", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count() if nccl else 2)
    if world < 2 or (nccl and world > torch.cuda.device_count()):
        raise SystemExit(f"--world {world}: the probe needs 2 or more "
                         "ranks, one a card under NCCL")
    ops = args.ops or list(COLLECTIVE_OPS)
    sizes = args.sizes or [1 << e for e in range(12, 27, 2)]
    kw = dict(ops=ops, dtypes=args.dtypes, sizes=sizes,
              group_sizes=args.groups, iters=args.iters, rounds=args.rounds,
              link_class=args.link_class)
    t0 = time.perf_counter()
    measurements, probe_s = probe(world, args.backend, kw,
                                  os.path.join("build", "comms_probe",
                                               f"w{world}"))
    if not measurements:
        print("probe produced no measurements", file=sys.stderr)
        return 2
    if simulate_dcn is not None:
        alpha, beta = simulate_dcn
        measurements += simulate_link_measurements(
            alpha, beta, link_class="dcn", ops=ops, dtypes=["f32"],
            sizes=sizes, group_sizes=args.groups or (2, 4))
    if args.holdout:
        train, held = holdout_split(measurements, every=args.holdout)
    else:
        train, held = list(measurements), []
    smi = ""
    if nccl:
        import chip_smoke
        smi = chip_smoke._smi()
    model = fit_cost_model(train, meta={
        "backend": args.backend, "world": world,
        "device_kind": (torch.cuda.get_device_name(0) if nccl else "cpu"),
        "nvidia_smi": smi, "iters": args.iters, "rounds": args.rounds})
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    model.save(args.out, measurements=measurements)

    curves = model.curves()
    print(f"wrote {args.out}: {len(curves)} fitted curves over "
          f"{len(train)} points at {world} ranks "
          f"(link classes: {', '.join(model.link_classes)})")
    for (op, dtype, lc), fit in sorted(curves.items()):
        print(f"  {op:<13} {dtype:<5} {lc:<4} alpha={fit.alpha_s!r} s/hop"
              f"  beta={fit.beta_s_per_byte!r} s/B"
              f"  fit_err<={fit.max_rel_err:.3f}")
    report = None
    if held:
        report = model.validate(held, tolerance=args.tolerance)
        ok = "OK" if report["within_tolerance"] else "FAIL"
        print(f"held-out validation [{ok}]: {report['n']} points, worst "
              f"ratio {report['worst_ratio']!r} (gate {args.tolerance}x)")
    res = dict(world=world, backend=args.backend, profile=args.out,
               probe_s=probe_s, seconds=time.perf_counter() - t0,
               fits={"|".join(k): dict(alpha_s=f.alpha_s,
                                       beta_s_per_byte=f.beta_s_per_byte,
                                       n_points=f.n_points,
                                       max_rel_err=f.max_rel_err)
                     for k, f in curves.items()},
               holdout=None if report is None else dict(
                   n=report["n"], worst_ratio=report["worst_ratio"],
                   within_tolerance=report["within_tolerance"],
                   rows=report["rows"]),
               measurements=[m.to_dict() for m in measurements])
    print(smi)
    print(json.dumps(res))
    return 0 if report is None or report["within_tolerance"] else 1


if __name__ == "__main__":
    sys.exit(main())
