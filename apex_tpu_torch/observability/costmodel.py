"""Measured collective cost model: probe -> alpha-beta ring fits — port of
``apex_tpu/observability/costmodel.py``.

:mod:`~apex_tpu_torch.observability.comms` counts the BYTES a call moves;
this module predicts the TIME those bytes take on the machine we are
actually running on.  An auto-parallel planner searches thousands of (dp,
tp, pp, SP, dtype) candidates — it cannot measure each one, so its quality
is bounded by the fidelity of a measured communication profile (AMP,
arXiv:2210.07297), and quantized collectives make the curve per-dtype
(EQuARX, arXiv:2506.17615).

Three pieces:

* :func:`probe_collectives` — microbenchmark ``all_reduce`` /
  ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` / a one-hop
  ``batch_isend_irecv`` ring over :mod:`torch.distributed` groups of 2 / 4
  / 8 ranks, across message sizes and dtypes (min of rounds, each window
  closed by a hard sync).  The curves keep the JAX package's op names
  (``psum``, ``all_gather``, ``psum_scatter``, ``ppermute``), so a profile
  JSON is the same document in both packages;
* :func:`fit_cost_model` — least-squares fit of the classic ring model
  per (op, dtype, link_class): ``t = alpha * hops(k) + beta *
  wire_bytes(n, k)`` where ``hops`` is the number of serialized ring
  steps and ``wire_bytes`` the per-link traffic (the same factors
  :func:`~apex_tpu_torch.observability.comms.wire_bytes` applies) — alpha
  is the per-hop latency, beta the inverse link bandwidth;
* :class:`CostModel` — ``predict(op, nbytes, group_size)`` in seconds,
  ``predict_stats`` over a ``collective_stats`` accounting dict, a
  ``validate`` report against held-out measurements, and a VERSIONED
  machine-profile JSON (:meth:`CostModel.save` / :func:`load_profile`) so
  a profile taken once per machine is reusable across runs — and refused
  when the schema moved on.

Online refits: a saved profile describes the machine at probe time, and
machines drift.  :meth:`CostModel.update` buffers fresh production
measurements and :meth:`CostModel.refit` fits them into a refreshed model,
with a :meth:`CostModel.drift_report` against the loaded profile — the
signal :class:`~apex_tpu_torch.resilience.autopilot.ParallelismAutopilot`
debounces before re-ranking plans.  Profiles are stamped with their probe
wall-time and measurement count (``meta["probed_at"]`` /
``meta["n_measurements"]``) so :meth:`CostModel.profile_age` /
:meth:`CostModel.is_stale` can tell "drifted" from "never probed here".

Two-tier fabrics: every measurement and fit carries a ``link_class`` —
the JAX names are kept: ``"ici"`` is the card-to-card fabric (NVLink
between the cards of one machine), ``"dcn"`` the network between machines
— fitted as SEPARATE curves, because one alpha-beta pair cannot describe
both.  :func:`simulate_link_measurements` synthesizes a slow link's curve
from explicit coefficients so the two-tier fit path runs where the link
cannot be probed (``tools/comms_probe_torch.py --simulate-dcn
alpha,beta``).

Everything but :func:`probe_collectives` is plain Python and numpy, copied
from the JAX package.  ``tools/comms_probe_torch.py`` is the CLI.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PROFILE_VERSION = 1

#: the collectives the probe measures, by the JAX package's (jax.lax) names
COLLECTIVE_OPS = ("psum", "all_gather", "psum_scatter", "ppermute")

#: collective kind (comms.collective_stats keys; the JAX package's HLO
#: instruction kinds) -> probe op.
#: all_to_all has no probe arm yet; ppermute's per-link model (factor
#: 1.0, one hop) is the closest stand-in.
HLO_KIND_TO_OP = {
    "all_reduce": "psum",
    "all_gather": "all_gather",
    "reduce_scatter": "psum_scatter",
    "collective_permute": "ppermute",
    "all_to_all": "ppermute",
}

_DTYPE_WIDTH = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1, "i8": 1}


def ring_hops(op: str, group_size: int) -> float:
    """Serialized ring steps for one collective over ``group_size``
    devices: a ring all-reduce runs ``2(k-1)`` hops (reduce-scatter
    phase + all-gather phase), gather/scatter ``k-1``, a permute 1."""
    k = max(int(group_size), 1)
    if op == "psum":
        return 2.0 * (k - 1)
    if op in ("all_gather", "psum_scatter"):
        return float(k - 1)
    if op == "ppermute":
        return 1.0
    raise ValueError(f"unknown collective op {op!r}")


def ring_wire_bytes(op: str, nbytes: int, group_size: int) -> float:
    """Per-link wire traffic for ``nbytes`` of payload — the same ring
    factors as :func:`~apex_tpu_torch.observability.comms.wire_bytes`
    (payload bytes use the comms accounting convention: the largest
    shape on the instruction)."""
    k = max(int(group_size), 1)
    if op == "psum":
        return nbytes * (2.0 * (k - 1) / k if k > 1 else 2.0)
    if op in ("all_gather", "psum_scatter"):
        return nbytes * ((k - 1) / k if k > 1 else 1.0)
    if op == "ppermute":
        return float(nbytes)
    raise ValueError(f"unknown collective op {op!r}")


@dataclasses.dataclass
class Measurement:
    """One probed point: ``time_s`` (min of rounds) for one execution
    of ``op`` moving ``nbytes`` of payload over ``group_size`` devices.
    ``nbytes`` follows the comms accounting convention so measured
    points line up with ``collective_stats`` byte counts.  ``link_class`` names
    the fabric the point was taken on (``"ici"`` intra-pod, ``"dcn"``
    cross-pod); points from before the field existed load as ici."""
    op: str
    dtype: str
    group_size: int
    nbytes: int
    time_s: float
    link_class: str = "ici"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        return cls(op=d["op"], dtype=d["dtype"],
                   group_size=int(d["group_size"]),
                   nbytes=int(d["nbytes"]), time_s=float(d["time_s"]),
                   link_class=str(d.get("link_class", "ici")))


@dataclasses.dataclass
class CostFit:
    """Fitted ring coefficients for one (op, dtype) curve."""
    alpha_s: float           # per-hop latency (startup) in seconds
    beta_s_per_byte: float   # seconds per wire byte (1 / link bandwidth)
    n_points: int = 0
    max_rel_err: float = 0.0   # worst |pred/meas - 1| over the fit set

    def predict(self, op: str, nbytes: int, group_size: int) -> float:
        return (self.alpha_s * ring_hops(op, group_size)
                + self.beta_s_per_byte
                * ring_wire_bytes(op, nbytes, group_size))


def _lstsq_fit(rows: List[Tuple[float, float, float]]) -> Tuple[float, float]:
    """Least-squares ``t = alpha*h + beta*w`` with both coefficients
    clamped non-negative (a negative latency or bandwidth is noise, and
    extrapolating with one inverts the size ordering)."""
    import numpy as np

    A = np.asarray([[h, w] for h, w, _ in rows], dtype=np.float64)
    t = np.asarray([y for _, _, y in rows], dtype=np.float64)
    if len(rows) == 1:
        # single point: attribute everything to latency
        h, w, y = rows[0]
        return (y / h if h else 0.0), 0.0
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    if beta < 0.0:            # latency-dominated noise: refit alpha only
        beta = 0.0
        hs = A[:, 0]
        alpha = float((t * hs).sum() / (hs * hs).sum()) if hs.any() else 0.0
    if alpha < 0.0:           # bandwidth-dominated: refit beta only
        alpha = 0.0
        ws = A[:, 1]
        beta = float((t * ws).sum() / (ws * ws).sum()) if ws.any() else 0.0
    return max(alpha, 0.0), max(beta, 0.0)


def fit_cost_model(measurements: Iterable[Measurement],
                   meta: Optional[dict] = None) -> "CostModel":
    """Fit one :class:`CostFit` per (op, dtype, link_class) curve by
    least squares over the ring design matrix ``[hops, wire_bytes]`` —
    ici and dcn points never mix into one fit."""
    groups: Dict[Tuple[str, str, str], List[Measurement]] = {}
    for m in measurements:
        groups.setdefault((m.op, m.dtype, m.link_class), []).append(m)
    fits: Dict[Tuple[str, str, str], CostFit] = {}
    for key, ms in groups.items():
        op = key[0]
        rows = [(ring_hops(op, m.group_size),
                 ring_wire_bytes(op, m.nbytes, m.group_size),
                 m.time_s) for m in ms]
        alpha, beta = _lstsq_fit(rows)
        fit = CostFit(alpha_s=alpha, beta_s_per_byte=beta,
                      n_points=len(ms))
        errs = [abs(fit.predict(m.op, m.nbytes, m.group_size)
                    / m.time_s - 1.0)
                for m in ms if m.time_s > 0]
        fit.max_rel_err = max(errs, default=0.0)
        fits[key] = fit
    return CostModel(fits, meta=meta)


class CostModel:
    """Per-(op, dtype, link_class) alpha-beta ring model with a
    versioned profile.

    ``predict`` never raises on an unknown dtype — it falls back to the
    op's f32 curve, then to any curve for the op (a planner asking
    about an un-probed dtype should get the conservative wider-dtype
    estimate, not an exception mid-search) — but an unknown OP raises:
    silently guessing a collective's algorithm would corrupt a plan
    comparison.  An un-probed ``link_class`` falls back to the ici
    curves the same way (the conservative choice would be the OTHER
    direction, but a planner probing dcn explicitly gets dcn curves;
    the fallback only covers profiles from before the tier existed).

    ``fits`` is the pre-link-class view — the **ici** curves keyed
    ``(op, dtype)`` — kept as the primary mutable mapping so existing
    callers and saved-profile round-trips are unchanged; construct with
    3-tuple keys ``(op, dtype, link_class)`` (or 2-tuple = ici) to
    populate other tiers, and read the full set via :meth:`curves`.
    """

    def __init__(self, fits: Dict[tuple, CostFit],
                 meta: Optional[dict] = None):
        self._by_class: Dict[str, Dict[Tuple[str, str], CostFit]] = {}
        for key, fit in dict(fits).items():
            if len(key) == 2:
                op, dtype = key
                lc = "ici"
            else:
                op, dtype, lc = key
            self._by_class.setdefault(str(lc), {})[(op, dtype)] = fit
        self._by_class.setdefault("ici", {})
        self.meta = dict(meta or {})
        # fresh production measurements buffered by update(), consumed
        # (and cleared) by a successful refit()
        self._fresh: List[Measurement] = []

    @property
    def fits(self) -> Dict[Tuple[str, str], CostFit]:
        """The ici curves keyed ``(op, dtype)`` (live view)."""
        return self._by_class["ici"]

    @property
    def link_classes(self) -> Tuple[str, ...]:
        return tuple(sorted(lc for lc, d in self._by_class.items() if d))

    def curves(self) -> Dict[Tuple[str, str, str], CostFit]:
        """Every fitted curve keyed ``(op, dtype, link_class)``."""
        return {(op, dtype, lc): fit
                for lc in sorted(self._by_class)
                for (op, dtype), fit in sorted(self._by_class[lc].items())}

    # -- staleness -----------------------------------------------------------

    def profile_age(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the profile was probed (``meta["probed_at"]``
        wall time, stamped by :meth:`save` and :meth:`refit`), or None
        for profiles that never carried the stamp."""
        probed = self.meta.get("probed_at")
        if probed is None:
            return None
        t = time.time() if now is None else now
        return max(0.0, float(t) - float(probed))

    def is_stale(self, max_age_s: float,
                 now: Optional[float] = None) -> bool:
        """True when the profile is older than ``max_age_s`` — or never
        carried a probe stamp at all ("never probed on this fleet" is
        stale by definition; "drifted" is a separate, measured signal —
        see :meth:`drift_report`)."""
        age = self.profile_age(now)
        return age is None or age > float(max_age_s)

    # -- online refits -------------------------------------------------------

    def update(self, measurements: Iterable[Measurement]) -> int:
        """Buffer fresh production measurements (collective timings from
        channels, traces, probes) for a later :meth:`refit`; returns the
        buffered count.  Cheap and non-blocking: nothing is fitted until
        refit() decides there is enough data."""
        self._fresh.extend(measurements)
        return len(self._fresh)

    @property
    def fresh_measurements(self) -> Tuple[Measurement, ...]:
        """The measurements buffered by :meth:`update` and not yet
        consumed by a successful :meth:`refit`."""
        return tuple(self._fresh)

    def drift_report(self, other: "CostModel",
                     group_size: int = 4) -> dict:
        """Relative drift of ``other``'s fitted curves vs this profile.

        Per shared (op, dtype, link_class) curve: the worst
        ``|t_other / t_self - 1|`` over a small probe grid of payload
        sizes — a pure function of the alpha-beta movement that weighs
        the coefficients the way the planner does (by predicted time),
        so a latency curve whose unused beta wiggles does not read as
        drift.  Returns ``{"curves": {key: drift}, "max_drift",
        "n_shared"}``; curves only one side fitted are skipped (no
        basis for comparison).
        """
        mine, theirs = self.curves(), other.curves()
        rows: Dict[str, float] = {}
        worst = 0.0
        for key in sorted(set(mine) & set(theirs)):
            op = key[0]
            deltas = []
            for nb in (1 << 12, 1 << 16, 1 << 20):
                t0 = mine[key].predict(op, nb, group_size)
                t1 = theirs[key].predict(op, nb, group_size)
                if t0 > 0.0:
                    deltas.append(abs(t1 / t0 - 1.0))
                elif t1 > 0.0:
                    deltas.append(math.inf)
            d = max(deltas, default=0.0)
            rows["|".join(key)] = d
            worst = max(worst, d)
        return {"curves": rows, "max_drift": worst,
                "n_shared": len(rows)}

    def refit(self, min_measurements: int = 8,
              meta: Optional[dict] = None,
              now: Optional[float] = None) -> dict:
        """Fit the buffered :meth:`update` measurements into a REFRESHED
        model and report how far it drifted from this one.

        Returns ``{"refitted", "reason", "n", "model", "drift"}``.  With
        fewer than ``min_measurements`` buffered points the refit is
        declined (``refitted=False``, buffer kept) — a handful of noisy
        samples must never move a plan.  On success the new model merges
        the freshly fitted curves over this profile's remaining ones
        (incremental update: un-remeasured tiers keep their old fits),
        carries this profile's meta re-stamped with ``probed_at`` /
        ``n_measurements``, and the buffer is cleared.  ``self`` is
        NEVER mutated: the caller — the autopilot — owns adoption of the
        refreshed model, after debouncing ``drift["max_drift"]``.
        """
        n = len(self._fresh)
        if n < int(min_measurements):
            return {"refitted": False, "n": n, "model": None,
                    "drift": None,
                    "reason": f"only {n} fresh measurement(s) "
                              f"(< {min_measurements}); keeping the "
                              "loaded profile"}
        m = dict(self.meta)
        m.update(meta or {})
        m["probed_at"] = float(time.time() if now is None else now)
        m["n_measurements"] = n
        fitted = fit_cost_model(self._fresh, meta=m)
        drift = self.drift_report(fitted)
        merged = dict(self.curves())
        merged.update(fitted.curves())
        model = CostModel(merged, meta=m)
        self._fresh = []
        return {"refitted": True, "n": n, "model": model,
                "drift": drift, "reason": ""}

    # -- prediction ----------------------------------------------------------

    def _fit_for(self, op: str, dtype: str,
                 link_class: str = "ici") -> CostFit:
        if op not in COLLECTIVE_OPS:
            raise ValueError(
                f"unknown collective op {op!r}; probed ops are "
                f"{COLLECTIVE_OPS}")
        classes = [link_class] + (["ici"] if link_class != "ici" else [])
        for lc in classes:
            d = self._by_class.get(lc, {})
            for key in ((op, dtype), (op, "f32")):
                if key in d:
                    return d[key]
            for (o, _), fit in sorted(d.items()):
                if o == op:
                    return fit
        for lc in sorted(self._by_class):
            for (o, _), fit in sorted(self._by_class[lc].items()):
                if o == op:
                    return fit
        raise KeyError(f"no fitted curve for op {op!r} "
                       f"(have {sorted(self.curves())})")

    def predict(self, op: str, nbytes: int, group_size: int,
                dtype: str = "f32", link_class: str = "ici") -> float:
        """Predicted seconds for one execution of ``op`` moving
        ``nbytes`` of payload over a ``group_size`` ring on the
        ``link_class`` fabric."""
        return self._fit_for(op, dtype, link_class).predict(
            op, nbytes, group_size)

    def predict_stats(self, stats: Dict[str, dict], group_size: int = 0,
                      dtype: str = "f32",
                      link_classes=None) -> Dict[str, dict]:
        """Predicted per-step communication time for a
        :func:`~apex_tpu_torch.observability.comms.collective_stats` result.

        Per kind: op count, payload bytes, and predicted seconds
        (ops without a parsed group size use ``group_size`` as the
        fallback ring width; 0 means "skip the latency term's hop
        count scaling" — a 2-wide ring).  ``link_classes`` picks the
        fabric per edge: a plain string prices every kind on that
        fabric, a dict maps kind -> link class (unlisted kinds stay
        ici) — how the MPMD planner prices a program whose all-reduces
        stay on ICI while its collective-permutes cross pods.  Returns
        the per-kind rows plus ``{"total_s": ...}`` — the objective the
        auto-parallel planner minimizes alongside compute time.
        """
        if link_classes is None:
            link_classes = {}
        if isinstance(link_classes, str):
            link_classes = {k: link_classes for k in HLO_KIND_TO_OP}
        out: Dict[str, dict] = {}
        total = 0.0
        for kind, op in HLO_KIND_TO_OP.items():
            row = stats.get(kind)
            if not row or not row.get("count"):
                continue
            lc = str(link_classes.get(kind, "ici"))
            pred = 0.0
            for o in row.get("ops", ()):
                k = o.get("group_size") or group_size or 2
                pred += self.predict(op, o["bytes"], k, dtype=dtype,
                                     link_class=lc)
            out[kind] = {"count": row["count"], "bytes": row["bytes"],
                         "pred_s": pred, "modeled_as": op,
                         "link_class": lc}
            total += pred
        out["total_s"] = total
        return out

    # -- validation ----------------------------------------------------------

    def validate(self, measurements: Iterable[Measurement],
                 tolerance: float = 2.0) -> dict:
        """Report predicted-vs-measured ratios over ``measurements``
        (typically a held-out split the fit never saw).  A curve is
        trustworthy for planning when every ratio lands within
        ``tolerance`` (the dryrun gate uses 2x)."""
        rows = []
        for m in measurements:
            pred = self.predict(m.op, m.nbytes, m.group_size,
                                dtype=m.dtype, link_class=m.link_class)
            ratio = (pred / m.time_s if m.time_s > 0 else math.inf)
            rows.append({"op": m.op, "dtype": m.dtype,
                         "group_size": m.group_size, "nbytes": m.nbytes,
                         "link_class": m.link_class,
                         "measured_s": m.time_s, "pred_s": pred,
                         "ratio": ratio})
        ratios = [r["ratio"] for r in rows if math.isfinite(r["ratio"])]
        worst = max((max(r, 1.0 / r) for r in ratios if r > 0),
                    default=1.0)
        return {"n": len(rows), "rows": rows,
                "worst_ratio": worst,
                "within_tolerance": bool(worst <= tolerance),
                "tolerance": tolerance}

    # -- profile JSON --------------------------------------------------------

    def to_json(self) -> dict:
        # ici curves keep their pre-link-class key form ("op|dtype") so
        # older readers of a fresh profile still parse them; every entry
        # carries an explicit link_class field, and non-ici curves get a
        # third key segment to avoid collisions
        fits = {}
        for (op, dtype, lc), fit in self.curves().items():
            key = f"{op}|{dtype}" if lc == "ici" else f"{op}|{dtype}|{lc}"
            fits[key] = {
                "alpha_s": fit.alpha_s,
                "beta_s_per_byte": fit.beta_s_per_byte,
                "n_points": fit.n_points,
                "max_rel_err": fit.max_rel_err,
                "link_class": lc,
            }
        return {
            "version": PROFILE_VERSION,
            "meta": self.meta,
            "fits": fits,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CostModel":
        ver = doc.get("version")
        if ver is None:
            # profiles written before versioning existed: still usable
            # alpha-beta data, but flag it — and is_stale() will report
            # them stale (no probed_at stamp either)
            warnings.warn(
                "machine profile carries no version field (written "
                "before profiles were versioned); loading anyway — "
                "re-run tools/comms_probe_torch.py to refresh it",
                stacklevel=2)
        elif ver != PROFILE_VERSION:
            raise ValueError(
                f"machine profile version {ver!r} != supported "
                f"{PROFILE_VERSION}; re-run tools/comms_probe_torch.py")
        fits = {}
        for key, f in doc.get("fits", {}).items():
            op, _, rest = key.partition("|")
            dtype, _, key_lc = rest.partition("|")
            # explicit field wins; then the key's third segment; a
            # version-current profile with neither is pre-link-class
            # data and loads as ici
            lc = str(f.get("link_class") or key_lc or "ici")
            fits[(op, dtype, lc)] = CostFit(
                alpha_s=float(f["alpha_s"]),
                beta_s_per_byte=float(f["beta_s_per_byte"]),
                n_points=int(f.get("n_points", 0)),
                max_rel_err=float(f.get("max_rel_err", 0.0)))
        return cls(fits, meta=doc.get("meta"))

    def save(self, path: str,
             measurements: Optional[Sequence[Measurement]] = None) -> str:
        """Write the machine profile (fits + meta + optionally the raw
        measurements, so a later re-fit can improve the model without
        re-probing).  Stamps staleness metadata: ``meta["probed_at"]``
        (wall time, kept if already set — a re-save does not make old
        data look fresh) and ``meta["n_measurements"]`` when the raw
        points are given."""
        self.meta.setdefault("probed_at", time.time())
        if measurements is not None:
            self.meta["n_measurements"] = len(measurements)
        doc = self.to_json()
        if measurements is not None:
            doc["measurements"] = [m.to_dict() for m in measurements]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path


def load_profile(path: str) -> Tuple[CostModel, List[Measurement]]:
    """Load a saved machine profile; returns the model and whatever raw
    measurements the file carried (empty list when none)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    model = CostModel.from_json(doc)
    ms = [Measurement.from_dict(d) for d in doc.get("measurements", ())]
    return model, ms


def holdout_split(measurements: Sequence[Measurement], every: int = 3
                  ) -> Tuple[List[Measurement], List[Measurement]]:
    """(train, held_out): within each (op, dtype, link_class, group)
    curve, hold out every ``every``-th point by size rank —
    interpolation-regime validation, which is what the planner asks of
    the model."""
    curves: Dict[Tuple[str, str, str, int], List[Measurement]] = {}
    for m in measurements:
        curves.setdefault((m.op, m.dtype, m.link_class, m.group_size),
                          []).append(m)
    train: List[Measurement] = []
    held: List[Measurement] = []
    for ms in curves.values():
        ms = sorted(ms, key=lambda m: m.nbytes)
        for i, m in enumerate(ms):
            # never hold out the endpoints: they anchor the fit's range
            if 0 < i < len(ms) - 1 and i % every == 1 and len(ms) > 2:
                held.append(m)
            else:
                train.append(m)
    return train, held


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def _payload_bytes(op: str, dtype: str, n_local: int, k: int) -> int:
    """Payload bytes under the comms accounting convention (largest
    shape on the instruction): psum/psum_scatter move the per-device
    operand, all_gather's payload is the gathered RESULT, ppermute the
    permuted tensor."""
    width = _DTYPE_WIDTH[dtype]
    if op == "all_gather":
        return n_local * k * width
    return n_local * width


def probe_collectives(ops: Sequence[str] = COLLECTIVE_OPS,
                      dtypes: Sequence[str] = ("f32", "bf16", "int8"),
                      sizes: Sequence[int] = (1 << 12, 1 << 14, 1 << 16,
                                              1 << 18, 1 << 20),
                      group_sizes: Optional[Sequence[int]] = None,
                      iters: int = 4, rounds: int = 5,
                      warmup: int = 1,
                      link_class: str = "ici",
                      verbose: bool = False) -> List[Measurement]:
    """Microbenchmark the ring collectives over :mod:`torch.distributed`.

    Every rank of the job calls it.  Each ring size ``k`` of
    ``group_sizes`` (default: 2, 4 and 8 where they divide the world) is a
    group of the first ``k`` ranks; the ops are ``all_reduce`` (``psum``),
    ``all_gather_into_tensor`` (``all_gather``), ``reduce_scatter_tensor``
    (``psum_scatter``) and a one-hop ``batch_isend_irecv`` ring
    (``ppermute``), named as in the JAX package so a profile is the same
    document in both.  The tensors live on this rank's card under NCCL and
    on the CPU under gloo.

    ``link_class`` tags every measurement with the fabric being probed:
    ``"ici"`` is the card-to-card fabric (NVLink within one machine),
    ``"dcn"`` the network between machines — run once per tier on groups
    whose rings cross that fabric.

    ``sizes`` are PER-RANK local buffer bytes.  The cell's time is the MIN
    over ``rounds`` windows of ``iters`` calls, each window opened by a
    barrier of the group and closed by a hard sync
    (``torch.cuda.synchronize`` under NCCL; gloo's calls return done) — the
    reproducible lower bound: host scheduling noise only ever ADDS time.
    The ranks' times are combined by their largest (the collective ends
    when its last rank does) and every rank returns the same list.  NCCL
    and gloo both run every op in f32, bf16 and int8, so a cell that fails
    is a fault and raises (the JAX probe skips cells a backend cannot
    run; here there are none).
    """
    import torch
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if group_sizes is None:
        group_sizes = [k for k in (2, 4, 8) if world % k == 0
                       and k <= world]
    group_sizes = [int(k) for k in group_sizes if 2 <= int(k) <= world]
    if not group_sizes:
        raise RuntimeError(
            f"no usable ring sizes at world size {world}; the probe needs "
            ">= 2 ranks of an initialised torch.distributed job (gloo on "
            "the CPU, NCCL with one rank per card)")

    rank = dist.get_rank()
    nccl = dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if nccl
              else torch.device("cpu"))
    torch_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
                    "int8": torch.int8}

    def sync():
        if nccl:
            torch.cuda.synchronize()

    # one group per ring size over the first k ranks (every rank creates
    # every group, as new_group requires)
    groups = {k: dist.new_group(list(range(k))) for k in group_sizes}
    out: List[Measurement] = []
    for k in group_sizes:
        group = groups[k]
        member = rank < k
        nxt, prv = (rank + 1) % k, (rank - 1) % k

        def call(op, x, buf):
            if op == "psum":
                dist.all_reduce(x, group=group)
            elif op == "all_gather":
                dist.all_gather_into_tensor(buf, x, group=group)
            elif op == "psum_scatter":
                dist.reduce_scatter_tensor(buf, x, group=group)
            else:
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, nxt, group=group),
                    dist.P2POp(dist.irecv, buf, prv, group=group)])
                for r in reqs:
                    r.wait()

        for op in ops:
            for dtype in dtypes:
                width = _DTYPE_WIDTH[dtype]
                for nbytes_local in sizes:
                    # local rows divisible by k for every op (the
                    # reduce-scatter splits them k ways)
                    n_local = max(nbytes_local // width, k)
                    n_local -= n_local % k
                    n_local = max(n_local, k)
                    t = -math.inf
                    if member:
                        x = torch.ones(n_local, dtype=torch_dtypes[dtype],
                                       device=device)
                        buf = torch.empty(
                            n_local * k if op == "all_gather"
                            else n_local // k if op == "psum_scatter"
                            else n_local, dtype=x.dtype, device=device)
                        for _ in range(warmup):
                            call(op, x, buf)
                        sync()
                        times = []
                        for _ in range(rounds):
                            dist.barrier(group=group)
                            sync()
                            t0 = time.perf_counter()
                            for _ in range(iters):
                                call(op, x, buf)
                            sync()
                            times.append((time.perf_counter() - t0) / iters)
                        t = min(times)
                    out.append(Measurement(
                        op=op, dtype=dtype, group_size=k,
                        nbytes=_payload_bytes(op, dtype, n_local, k),
                        time_s=t, link_class=link_class))
        # the cell's time is its slowest rank's; ranks outside the group
        # contribute nothing (-inf)
        mine = [m for m in out if m.group_size == k]
        local = torch.tensor([m.time_s for m in mine], dtype=torch.float64,
                             device=device)
        dist.all_reduce(local, op=dist.ReduceOp.MAX)
        for m, v in zip(mine, local.tolist()):
            m.time_s = v
    if verbose and rank == 0:
        for m in out:
            print(f"probe {m.op:<13} {m.dtype:<5} k={m.group_size} "
                  f"payload={m.nbytes:>10,}B  t={m.time_s * 1e6:.1f}us")
    return out


def simulate_link_measurements(
        alpha_s: float, beta_s_per_byte: float, *,
        link_class: str = "dcn",
        ops: Sequence[str] = COLLECTIVE_OPS,
        dtypes: Sequence[str] = ("f32",),
        sizes: Sequence[int] = (1 << 12, 1 << 14, 1 << 16, 1 << 18,
                                1 << 20),
        group_sizes: Sequence[int] = (2, 4),
        rel_noise: float = 0.0, seed: int = 0) -> List[Measurement]:
    """Synthesize measurements for a link that cannot be probed here.

    Times follow the ring model exactly — ``t = alpha*hops +
    beta*wire_bytes`` — so a fit over the output recovers the given
    coefficients (``rel_noise`` adds deterministic multiplicative
    jitter when a less-than-perfect curve is wanted).  This is how a
    CPU-only CI exercises the dcn tier end to end: inject a slow
    link's alpha-beta, fit, and drive the MPMD planner/simulator with
    the result (``tools/comms_probe_torch.py --simulate-dcn alpha,beta``).
    """
    import numpy as np

    rng = np.random.RandomState(seed)
    out: List[Measurement] = []
    for op in ops:
        for dtype in dtypes:
            width = _DTYPE_WIDTH[dtype]
            for k in group_sizes:
                for nbytes_local in sizes:
                    n_local = max(nbytes_local // width, k)
                    n_local -= n_local % k
                    n_local = max(n_local, k)
                    nbytes = _payload_bytes(op, dtype, n_local, k)
                    t = (alpha_s * ring_hops(op, k)
                         + beta_s_per_byte
                         * ring_wire_bytes(op, nbytes, k))
                    if rel_noise:
                        t *= 1.0 + rel_noise * float(
                            rng.uniform(-1.0, 1.0))
                    out.append(Measurement(
                        op=op, dtype=dtype, group_size=k,
                        nbytes=nbytes, time_s=t,
                        link_class=link_class))
    return out
