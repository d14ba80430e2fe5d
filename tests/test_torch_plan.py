"""``ParallelPlan`` of apex_tpu_torch against apex_tpu's, and its
consumers: on one grid of inputs the same accept / raise decisions with
the same messages, ``to_dict`` equal to JAX's dict, round trips through
``from_dict`` (and pre-plan topology dicts), the projections, the
configs' ``plan=`` (the plan wins a conflicting knob with JAX's
DeprecationWarning), the serving engine's three checks and the ZeRO
optimizers' ``plan=``.  In one process, exactly."""

import warnings

import pytest
import torch

from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.inference import InferenceEngine as JEngine
from apex_tpu.parallel import DistributedFusedAdam as JDFAdam
from apex_tpu.parallel import plan as jplan

from apex_tpu_torch.inference import InferenceEngine
from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.parallel import (PLAN_VERSION, DistributedFusedAdam,
                                     DistributedFusedLAMB, ParallelPlan)
from apex_tpu_torch.parallel import plan as tplan

GRID = [
    dict(), dict(dp=2, tp=2, pp=2), dict(tp=2, sequence_parallel=True),
    dict(sequence_parallel=True), dict(tp=2, overlap_chunks=2),
    dict(tp=2, sequence_parallel=True, overlap_chunks=2),
    dict(overlap_chunks=-1), dict(dp=0), dict(tp=True), dict(pp=1.5),
    dict(dp=4, zero_shard=4), dict(dp=4, zero_shard=2),
    dict(pp=2, n_virtual=2, n_microbatches=4),
    dict(pp=2, n_virtual=2, n_microbatches=3), dict(n_virtual=2),
    dict(remat=True, remat_policy="dots"), dict(remat_policy="some"),
    dict(allreduce_dtype="f32"), dict(allreduce_dtype="int8"),
    dict(allreduce_dtype="fp8"), dict(fused_ffn=True),
    dict(pp=4, n_pods=2), dict(pp=3, n_pods=2),
    dict(pp=2, n_pods=2, n_virtual=2, n_microbatches=2),
    dict(stage_plans=(dict(),)),
    dict(pp=2, n_pods=2, stage_plans=(dict(tp=2), dict())),
    dict(pp=2, n_pods=2, stage_plans=(dict(),)),
    dict(pp=2, n_pods=2, stage_plans=(dict(pp=2), dict())),
    dict(dp=2, pp=2, n_pods=2, stage_plans=(dict(), dict(dp=2))),
    dict(pp=2, n_pods=2, stage_plans="bad"),
]


def _build(mod, kw):
    kw = dict(kw)
    if isinstance(kw.get("stage_plans"), tuple):
        kw["stage_plans"] = tuple(mod.ParallelPlan(**p)
                                  for p in kw["stage_plans"])
    try:
        return mod.ParallelPlan(**kw), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("kw", GRID, ids=[str(i) for i in range(len(GRID))])
def test_plan_decisions_messages_and_dicts_match_jax(kw):
    (jp, je), (tp, te) = _build(jplan, kw), _build(tplan, kw)
    assert te == je
    if jp is None:
        return
    assert tp.to_dict() == jp.to_dict()
    assert tp.model_kwargs() == jp.model_kwargs()
    assert tp.optimizer_kwargs() == jp.optimizer_kwargs()
    assert (tp.n_devices, tp.axis_name, tp.describe()) == \
        (jp.n_devices, jp.axis_name, jp.describe())
    assert ParallelPlan.from_dict(tp.to_dict()) == tp


def test_from_dict_lifts_topology_dicts_and_refuses_other_versions():
    topo = dict(dp=2, tp=2, pp=1, sequence_parallel=True, zero_shard=2)
    assert ParallelPlan.from_dict(topo).to_dict() == \
        jplan.ParallelPlan.from_dict(topo).to_dict()
    assert ParallelPlan.from_dict(topo, remat=True).remat
    bad = dict(topo, version=PLAN_VERSION + 1)
    with pytest.raises(ValueError) as got:
        ParallelPlan.from_dict(bad)
    with pytest.raises(ValueError) as want:
        jplan.ParallelPlan.from_dict(bad)
    assert str(got.value) == str(want.value)
    assert PLAN_VERSION == jplan.PLAN_VERSION


def test_topology_waits_for_the_elastic_port():
    """The elastic port is in: ``topology`` / ``from_topology`` give the
    JAX plan's dicts, and ``spec.to_plan().topology() == spec``."""
    from apex_tpu.resilience.elastic import TopologySpec as JTopologySpec
    from apex_tpu_torch.resilience import TopologySpec
    for kw in (dict(), dict(dp=4, zero_shard=4),
               dict(dp=2, tp=2, sequence_parallel=True, pp=2)):
        tp, jp = ParallelPlan(**kw), jplan.ParallelPlan(**kw)
        assert tp.topology().to_dict() == jp.topology().to_dict()
        spec, jspec = TopologySpec(**kw), JTopologySpec(**kw)
        over = dict(remat=True, n_microbatches=4)
        assert ParallelPlan.from_topology(spec, **over).to_dict() == \
            jplan.ParallelPlan.from_topology(jspec, **over).to_dict()
        assert ParallelPlan.from_topology(spec.to_dict()).to_dict() == \
            jplan.ParallelPlan.from_topology(jspec.to_dict()).to_dict()
        assert spec.to_plan().topology() == spec


_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=16)


def _warned(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [(x.category, str(x.message)) for x in w]


@pytest.mark.parametrize("bert", [False, True], ids=["gpt", "bert"])
def test_configs_fold_the_plan_as_jax(bert):
    """The plan's knobs land on the config; a conflicting non-default knob
    is superseded with JAX's DeprecationWarning; ``axis_name`` defaults to
    "model" under tensor parallelism."""
    tcls, jcls = (BertConfig, JBertConfig) if bert else (GPTConfig,
                                                         JGPTConfig)
    plan = dict(tp=2, sequence_parallel=True, overlap_chunks=2, remat=True,
                remat_policy="dots")
    kw = dict(_TINY, tensor_parallel_size=4, remat_policy="full")
    got, tw = _warned(lambda: tcls(**kw, plan=ParallelPlan(**plan)))
    want, jw = _warned(lambda: jcls(**kw, plan=jplan.ParallelPlan(**plan)))
    assert tw == jw and tw
    for f in ("tensor_parallel_size", "axis_name", "sequence_parallel",
              "overlap_chunks", "fused_ffn", "remat", "remat_policy"):
        assert getattr(got, f) == getattr(want, f), f
    silent, none = _warned(lambda: tcls(**_TINY, plan=ParallelPlan()))
    assert none == [] and silent.tensor_parallel_size == 1


@pytest.mark.parametrize("plan", [dict(pp=2), dict(tp=2,
                                                   sequence_parallel=True),
                                  dict(tp=2), dict()],
                         ids=["pp", "sp", "tp", "ok"])
def test_engine_checks_the_plan_as_jax(plan):
    import jax
    jm = JGPTModel(JGPTConfig(**_TINY))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = GPTModel(GPTConfig(**_TINY), device="cpu")

    def build(fn):
        try:
            fn()
            return None
        except ValueError as e:
            return str(e)
    want = build(lambda: JEngine(jm, jparams,
                                 plan=jplan.ParallelPlan(**plan)))
    got = build(lambda: InferenceEngine(tm, device="cpu",
                                        plan=ParallelPlan(**plan)))
    assert got == want
    if not plan:
        assert InferenceEngine(tm, device="cpu",
                               plan=ParallelPlan()).plan == ParallelPlan()


@pytest.mark.parametrize("cls", [DistributedFusedAdam, DistributedFusedLAMB],
                         ids=["adam", "lamb"])
def test_zero_optimizers_take_the_plan(cls):
    """``plan=`` sets the transport from ``allreduce_dtype`` and the shard
    count from ``zero_shard``; a conflicting knob is superseded with JAX's
    warning; a shard count other than the data group's size raises (one
    rank here)."""
    p = [torch.nn.Parameter(torch.ones(4))]
    opt, tw = _warned(lambda: cls(p, plan=ParallelPlan(allreduce_dtype="bf16"),
                                  allreduce_dtype="int8"))
    assert opt.allreduce_dtype == "bf16" and opt.plan.allreduce_dtype == \
        "bf16"
    _, jw = _warned(lambda: JDFAdam(plan=jplan.ParallelPlan(
        allreduce_dtype="bf16"), allreduce_dtype="int8"))
    assert tw == jw and tw
    with pytest.raises(ValueError, match="world_size=2"):
        cls(p, plan=ParallelPlan(dp=2, zero_shard=2))
