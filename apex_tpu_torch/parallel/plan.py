"""``ParallelPlan`` — the one validated object every subsystem consumes;
port of ``apex_tpu/parallel/plan.py``.

* Every cross-knob rule lives here, once: SP needs tp>1,
  ``overlap_chunks`` needs SP, ``zero_shard`` ∈ {1, dp}, the interleaved
  schedule needs ``n_microbatches % pp == 0``, ``n_virtual > 1`` needs
  ``pp > 1``, and the cross-pod (``n_pods``) rules.
* The consumers project it: :meth:`ParallelPlan.model_kwargs` feeds the
  model configs (``GPTConfig(plan=)`` / ``BertConfig(plan=)`` through
  :func:`apply_plan_to_config`), :meth:`ParallelPlan.optimizer_kwargs` the
  ZeRO optimizers, and ``InferenceEngine(plan=)`` checks it against the
  model.
* :meth:`ParallelPlan.to_dict` / :meth:`ParallelPlan.from_dict` are the
  versioned JSON form (``PLAN_VERSION``), equal to the JAX package's.

:meth:`ParallelPlan.topology` and :meth:`ParallelPlan.from_topology`
project onto the elastic layer's :class:`~apex_tpu_torch.resilience.
elastic.TopologySpec` (the checkpoint manifests' schema).  A plan with
``n_pods > 1`` validates as in JAX and runs on
:class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline` (its stages at ``tp ==
1``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["PLAN_VERSION", "ParallelPlan", "apply_plan_to_config"]

# bump when the dict schema changes incompatibly; from_dict refuses
# documents stamped with a different version (missing == pre-plan
# topology dicts, accepted as the TopologySpec projection)
PLAN_VERSION = 1

_ALLREDUCE_DTYPES = (None, "f32", "bf16", "int8")
_REMAT_POLICIES = ("full", "dots")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One validated description of a training parallelism layout.

    ``dp``/``tp``/``pp`` are the mesh axis sizes (``data``/``model``/
    ``pipe``); ``sequence_parallel`` and ``overlap_chunks`` configure
    the Megatron TP layers; ``n_virtual``/``n_microbatches`` the ring
    pipeline schedule (1F1B when ``n_virtual == 1``, interleaved
    otherwise); ``remat``/``remat_policy`` per-layer activation
    checkpointing; ``zero_shard`` the ZeRO optimizer-state shard factor
    over the data axis (1 = per-leaf fused optimizers, ``dp`` = the
    distributed optimizers); ``allreduce_dtype`` the ZeRO gradient
    reduce-scatter transport (None/'f32' exact, 'bf16'/'int8'
    compressed — see :mod:`apex_tpu_torch.utils.compressed_allreduce`).

    Cross-pod (MPMD): ``n_pods > 1`` splits the
    ``pp`` pipeline stages into contiguous per-pod blocks whose
    boundary edges cross the slow (DCN) tier; ``stage_plans`` — one
    intra-pod SPMD plan per pod (``pp=1``, ``n_pods=1``, same ``dp``)
    — lets pods run heterogeneous tp/SP layouts.  Plans with
    ``n_pods > 1`` are executed by the host-driven MPMD pipeline
    (:class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline`; tp > 1 inside a
    stage is not ported), not the ring engine.
    """

    dp: int = 1
    tp: int = 1
    pp: int = 1
    sequence_parallel: bool = False
    overlap_chunks: int = 0
    fused_ffn: bool = False
    n_virtual: int = 1
    n_microbatches: int = 1
    remat: bool = False
    remat_policy: str = "full"
    allreduce_dtype: Optional[str] = None
    zero_shard: int = 1
    n_pods: int = 1
    stage_plans: Optional[tuple] = None

    def __post_init__(self):
        for name in ("dp", "tp", "pp", "n_virtual", "n_microbatches",
                     "zero_shard", "n_pods"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or isinstance(v, bool) \
                    or v < 1:
                raise ValueError(
                    f"{name} must be a positive int, got {v!r}")
        if not isinstance(self.overlap_chunks, (int, np.integer)) \
                or self.overlap_chunks < 0:
            raise ValueError(
                f"overlap_chunks must be an int >= 0, got "
                f"{self.overlap_chunks!r}")
        if self.zero_shard not in (1, self.dp):
            raise ValueError(
                f"zero_shard must be 1 or dp ({self.dp}), got "
                f"{self.zero_shard}: ZeRO shards the data axis")
        if self.sequence_parallel and self.tp == 1:
            raise ValueError("sequence_parallel requires tp > 1")
        if self.overlap_chunks > 0 and not self.sequence_parallel:
            raise ValueError(
                "overlap_chunks rings the sequence-parallel "
                "collective/GEMM pairs; it requires "
                "sequence_parallel=True")
        if self.n_virtual > 1 and self.pp == 1:
            raise ValueError(
                "n_virtual > 1 (interleaved schedule) requires pp > 1")
        if self.n_virtual > 1 and self.n_microbatches % self.pp:
            raise ValueError(
                f"interleaved schedule needs n_microbatches % pp == 0, "
                f"got M={self.n_microbatches} pp={self.pp}")
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {_REMAT_POLICIES}, got "
                f"{self.remat_policy!r}")
        if self.allreduce_dtype not in _ALLREDUCE_DTYPES:
            raise ValueError(
                f"allreduce_dtype must be one of {_ALLREDUCE_DTYPES}, "
                f"got {self.allreduce_dtype!r}")
        # normalize the exact-transport spelling so plan equality (and
        # the JSON round-trip) has one canonical form
        if self.allreduce_dtype == "f32":
            object.__setattr__(self, "allreduce_dtype", None)
        self._validate_cross_pod()

    def _validate_cross_pod(self):
        if self.pp % self.n_pods:
            raise ValueError(
                f"n_pods ({self.n_pods}) must divide pp ({self.pp}): "
                "cross-pod MPMD assigns each pod a contiguous block of "
                f"pp/n_pods pipeline stages — pick pp a multiple of "
                "n_pods (or drop n_pods for a single-pod ring pipeline)")
        if self.n_pods > 1 and self.n_virtual > 1:
            raise ValueError(
                f"n_virtual ({self.n_virtual}) > 1 does not compose "
                f"with n_pods ({self.n_pods}) > 1: the interleaved "
                "virtual-stage schedule belongs to the single-program "
                "ring engine, while the MPMD engine schedules whole "
                "per-pod stage programs — set n_virtual=1, or keep the "
                "pipeline inside one pod for interleaving")
        if self.stage_plans is None:
            return
        if self.n_pods <= 1:
            raise ValueError(
                f"stage_plans given but n_pods is {self.n_pods}: "
                "per-stage plans describe the intra-pod layout of an "
                "MPMD cross-pod pipeline — set n_pods > 1 (one plan "
                "per pod), or drop stage_plans to run the single-pod "
                "ring engine")
        plans = self.stage_plans
        if isinstance(plans, ParallelPlan) or not isinstance(
                plans, (tuple, list)):
            raise ValueError(
                f"stage_plans must be a sequence of ParallelPlan (one "
                f"per pod), got {type(plans).__name__}")
        plans = tuple(
            p if isinstance(p, ParallelPlan) else ParallelPlan.from_dict(p)
            for p in plans)
        if len(plans) != self.n_pods:
            raise ValueError(
                f"stage_plans has {len(plans)} entries but n_pods is "
                f"{self.n_pods}: exactly one intra-pod plan per pod — "
                "pods without an override should carry an explicit "
                "default plan, not be omitted")
        for i, sp in enumerate(plans):
            if sp.pp != 1 or sp.n_pods != 1 or sp.stage_plans is not None:
                raise ValueError(
                    f"stage_plans[{i}] must be an intra-pod SPMD plan "
                    f"with pp=1 and n_pods=1 (got pp={sp.pp}, "
                    f"n_pods={sp.n_pods}): the cross-pod schedule owns "
                    "the pipeline dimension — nested pipelines/pods are "
                    "not supported; fold extra stages into pp on the "
                    "cross-pod plan instead")
            if sp.dp != self.dp:
                raise ValueError(
                    f"stage_plans[{i}].dp ({sp.dp}) must equal the "
                    f"cross-pod plan's dp ({self.dp}): activations "
                    "cross the DCN per data shard, so every pod must "
                    "slice the batch identically — vary tp/SP per pod, "
                    "not dp")
        object.__setattr__(self, "stage_plans", plans)

    # -- projections ---------------------------------------------------------

    @property
    def n_devices(self) -> int:
        if self.stage_plans is not None:
            # heterogeneous pods: each of the pp stage programs owns
            # its pod's dp x tp worth of devices
            per_pod_stages = self.pp // self.n_pods
            return per_pod_stages * sum(sp.dp * sp.tp
                                        for sp in self.stage_plans)
        return self.dp * self.tp * self.pp

    @property
    def axis_name(self) -> Optional[str]:
        """The TP mesh axis the model layers reduce over (``None`` when
        the plan has no tensor parallelism)."""
        return "model" if self.tp > 1 else None

    def topology(self):
        """Project onto the elastic layer's :class:`~apex_tpu_torch.
        resilience.elastic.TopologySpec` (the checkpoint-manifest schema —
        lossless for the fields it carries)."""
        from apex_tpu_torch.resilience.elastic import TopologySpec
        return TopologySpec(dp=self.dp, tp=self.tp, pp=self.pp,
                            sequence_parallel=self.sequence_parallel,
                            zero_shard=self.zero_shard)

    @classmethod
    def from_topology(cls, spec, **overrides) -> "ParallelPlan":
        """Lift a :class:`TopologySpec` (or its manifest dict form) into a
        full plan; ``overrides`` supply the knobs the spec does not carry
        (schedule, remat, transport)."""
        if isinstance(spec, dict):
            return cls.from_dict(spec, **overrides)
        return cls(dp=spec.dp, tp=spec.tp, pp=spec.pp,
                   sequence_parallel=spec.sequence_parallel,
                   zero_shard=spec.zero_shard, **overrides)

    def model_kwargs(self) -> dict:
        """The :class:`GPTConfig`/:class:`BertConfig` knobs this plan
        pins (pass alongside the architecture fields, or just pass
        ``plan=`` — the configs accept the plan object directly)."""
        return {"tensor_parallel_size": self.tp,
                "axis_name": self.axis_name,
                "sequence_parallel": self.sequence_parallel,
                "overlap_chunks": self.overlap_chunks,
                "fused_ffn": self.fused_ffn,
                "remat": self.remat,
                "remat_policy": self.remat_policy}

    def optimizer_kwargs(self) -> dict:
        """Ctor kwargs for the distributed (ZeRO) optimizers: the shard
        factor is ``zero_shard`` and the transport the plan's
        ``allreduce_dtype``."""
        return {"world_size": self.zero_shard,
                "axis_name": "data",
                "allreduce_dtype": self.allreduce_dtype}

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = {"version": PLAN_VERSION,
             "dp": int(self.dp), "tp": int(self.tp), "pp": int(self.pp),
             "sequence_parallel": bool(self.sequence_parallel),
             "overlap_chunks": int(self.overlap_chunks),
             "n_virtual": int(self.n_virtual),
             "n_microbatches": int(self.n_microbatches),
             "remat": bool(self.remat),
             "remat_policy": str(self.remat_policy),
             "allreduce_dtype": self.allreduce_dtype,
             "zero_shard": int(self.zero_shard)}
        # opt-in fields only when set, so default plan documents stay
        # byte-identical to earlier writers
        if self.fused_ffn:
            d["fused_ffn"] = True
        if self.n_pods != 1:
            d["n_pods"] = int(self.n_pods)
        if self.stage_plans is not None:
            d["stage_plans"] = [sp.to_dict() for sp in self.stage_plans]
        return d

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "ParallelPlan":
        """Rebuild from :meth:`to_dict` output OR a pre-plan topology
        dict (checkpoint manifests: dp/tp/pp/sequence_parallel/zero_shard, no
        version key) — the fields a topology dict lacks default, so old
        stamped manifests lift losslessly."""
        ver = d.get("version")
        if ver is not None and ver != PLAN_VERSION:
            raise ValueError(
                f"plan version {ver!r} != supported {PLAN_VERSION}; "
                "re-run tools/autotune.py to emit a current plan")
        kw = {"dp": int(d.get("dp", 1)), "tp": int(d.get("tp", 1)),
              "pp": int(d.get("pp", 1)),
              "sequence_parallel": bool(d.get("sequence_parallel", False)),
              "overlap_chunks": int(d.get("overlap_chunks", 0)),
              "fused_ffn": bool(d.get("fused_ffn", False)),
              "n_virtual": int(d.get("n_virtual", 1)),
              "n_microbatches": int(d.get("n_microbatches", 1)),
              "remat": bool(d.get("remat", False)),
              "remat_policy": str(d.get("remat_policy", "full")),
              "allreduce_dtype": d.get("allreduce_dtype"),
              "zero_shard": int(d.get("zero_shard", 1)),
              "n_pods": int(d.get("n_pods", 1))}
        if d.get("stage_plans") is not None:
            kw["stage_plans"] = tuple(
                cls.from_dict(sp) for sp in d["stage_plans"])
        kw.update(overrides)
        return cls(**kw)

    def describe(self) -> str:
        bits = [f"dp={self.dp}", f"tp={self.tp}", f"pp={self.pp}",
                f"sp={'on' if self.sequence_parallel else 'off'}",
                f"zero={self.zero_shard}"]
        if self.overlap_chunks:
            bits.append(f"overlap={self.overlap_chunks}")
        if self.fused_ffn:
            bits.append("ffn=fused")
        if self.pp > 1 or self.n_microbatches > 1:
            bits.append(f"mb={self.n_microbatches}")
        if self.n_virtual > 1:
            bits.append(f"v={self.n_virtual}")
        if self.remat:
            bits.append(f"remat={self.remat_policy}")
        if self.allreduce_dtype:
            bits.append(f"rs={self.allreduce_dtype}")
        if self.n_pods > 1:
            bits.append(f"pods={self.n_pods}")
            if self.stage_plans is not None:
                bits.append("stages=[" + "; ".join(
                    sp.describe() for sp in self.stage_plans) + "]")
        return " ".join(bits)


# -- config back-compat bridge ------------------------------------------------

_CONFIG_KNOBS = ("tensor_parallel_size", "sequence_parallel",
                 "overlap_chunks", "fused_ffn", "remat", "remat_policy")


def apply_plan_to_config(cfg) -> None:
    """Fold ``cfg.plan`` into a model config's per-knob parallelism
    fields (called by ``GPTConfig``/``BertConfig.__post_init__`` before
    their own validation).

    The per-knob kwargs remain the back-compat surface: passing them
    WITHOUT a plan stays silent and builds the internal plan elsewhere.
    Passing a plan AND a conflicting non-default knob is the superseded
    case — the plan wins and a :class:`DeprecationWarning` names the
    knob.  ``axis_name`` defaults from the plan (``"model"`` when
    ``tp > 1``) but an explicit value is kept, so parallel_state-style
    custom axis naming still composes.
    """
    plan = cfg.plan
    if plan is None:
        return
    import warnings
    values = {"tensor_parallel_size": plan.tp,
              "sequence_parallel": plan.sequence_parallel,
              "overlap_chunks": plan.overlap_chunks,
              "fused_ffn": plan.fused_ffn,
              "remat": plan.remat,
              "remat_policy": plan.remat_policy}
    for field in _CONFIG_KNOBS:
        default = cfg.__dataclass_fields__[field].default
        cur, want = getattr(cfg, field), values[field]
        if cur != default and cur != want:
            warnings.warn(
                f"{type(cfg).__name__}.{field}={cur!r} is superseded by "
                f"the attached ParallelPlan ({field}={want!r}); set the "
                "knob on the plan instead", DeprecationWarning,
                stacklevel=4)
        setattr(cfg, field, want)
    if cfg.axis_name is None and plan.tp > 1:
        cfg.axis_name = "model"
