"""apex_tpu_torch.mpmd against apex_tpu.mpmd, on the CPU.

* The schedules: for S in 1..4, M in 1..8 and both schedules the orders,
  ``stage_ops_1f1b`` (with ``extra_inflight`` 0..3), ``edge_link_classes``
  and ``simulate``'s dicts (to 1e-12, blocking and asynchronous sends)
  equal JAX's, and so do the errors of ``validate_order``,
  ``merge_stage_ops``, ``stage_ops_1f1b`` and ``edge_link_classes``.
* ``MpmdPipeline`` against JAX's ``MpmdPipeline`` on the small GPT of
  ``tests/test_mpmd.py`` (vocab 32, hidden 16, 4 layers, 4 heads, seq 16;
  M = 4 micro-batches of 2 rows a data shard) at (dp, pp, n_pods) = (1, 2,
  2), (2, 2, 2), (1, 4, 2), (2, 4, 4), each port schedule against one JAX
  run a layout (JAX's engine accumulates in ascending micro-batch order in
  either schedule, and the port's two schedules are held bit for bit equal
  to each other): the loss within rtol 1e-5 / atol 1e-6 and each gradient
  within 1e-5 of its largest entry (``tests/_torch_pp.py``'s tolerances);
  both tied-embedding replicas equal bit for bit.  One ``train_step``
  against JAX's.
* At dp = 1 against the port's ring engine (``pipeline_step`` over 2 and 4
  ``gloo`` ranks, one spawn each, started before the JAX runs): the loss and
  every gradient bit for bit.
* The scheduled ``dcn_fault`` retried once, the flow chains unbroken
  (M + 1 complete chains), kill-one-stage restore, the plan-stamp
  mismatch, ``MPMD_PLAN.json`` equal to JAX's, and the refusals (JAX's
  messages; ``tp > 1`` inside a stage is not ported).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import (GPTConfig as JConfig, GPTModel as JModel,
                                 unpack_from_shard_map)
from apex_tpu.mpmd import MpmdPipeline as JPipeline
from apex_tpu.mpmd import schedule as jsched
from apex_tpu.parallel.plan import ParallelPlan as JPlan
from apex_tpu.resilience.faults import (Fault as JFault,
                                        FaultInjector as JInjector)

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, pipeline_layer_ids
from apex_tpu_torch.mpmd import MPMD_PLAN_FILE, MpmdPipeline, StageProgram
from apex_tpu_torch.mpmd import schedule as tsched
from apex_tpu_torch.parallel.plan import ParallelPlan
from apex_tpu_torch.resilience.faults import Fault, FaultInjector

from _torch_pp import _close, _close_grad, spawn

KW = dict(vocab_size=32, hidden_size=16, num_layers=4,
          num_attention_heads=4, max_seq_len=16)
M, MB, SEQ = 4, 2, 16
LAYOUTS = [(1, 2, 2), (2, 2, 2), (1, 4, 2), (2, 4, 4)]
# the schedule JAX's engine runs at each layout (both are exercised)
JAX_SCHEDULE = {(1, 2, 2): "1f1b", (2, 2, 2): "dcn_hiding",
                (1, 4, 2): "dcn_hiding", (2, 4, 4): "1f1b"}
SCHEDULES = ("1f1b", "dcn_hiding")


# -- the schedules ------------------------------------------------------------

def _same(got, want, path="sim"):
    """Equal structures; floats to 1e-12 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), path
    else:
        assert got == want, path


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_schedules_and_simulate_match_jax(S):
    for m in range(1, 9):
        for extra in range(4):
            assert (tsched.stage_ops_1f1b(S, m, extra_inflight=extra)
                    == jsched.stage_ops_1f1b(S, m, extra_inflight=extra))
        for name in SCHEDULES:
            order = tsched.SCHEDULES[name](S, m)
            assert order == jsched.SCHEDULES[name](S, m)
            assert all(type(op) is tsched.Op for op in order)
            tsched.validate_order(order, S, m)
            for pods in [p for p in range(1, S + 1) if S % p == 0]:
                classes = tsched.edge_link_classes(S, pods)
                assert classes == jsched.edge_link_classes(S, pods)
                link = {e: (0.7 if c == "dcn" else 0.05) * (1 + 0.1 * e)
                        for e, c in classes.items()}
                for blocking in (True, False):
                    kw = dict(t_fwd=1.3, t_bwd=2.1, link_seconds=link,
                              link_classes=classes, blocking_sends=blocking)
                    _same(tsched.simulate(order, S, m, **kw),
                          jsched.simulate(order, S, m, **kw))
        assert (tsched.schedule_dcn_hiding(S, m, extra_inflight=2)
                == jsched.schedule_dcn_hiding(S, m, extra_inflight=2))


def test_schedule_errors_match_jax():
    Op = tsched.Op
    bad_orders = [
        ([Op(1, "fwd", 0)], 2, 1), ([Op(1, "bwd", 0)], 2, 1),
        ([Op(0, "fwd", 0), Op(0, "fwd", 0)], 1, 1),
        ([Op(0, "fwd", 0), Op(0, "bwd", 0)], 1, 2),
        ([Op(0, "fwd", 0), Op(1, "fwd", 0), Op(0, "bwd", 0)], 2, 1),
        ([Op(2, "fwd", 0)], 2, 1), ([Op(0, "up", 0)], 1, 1)]
    for order, s, m in bad_orders:
        got = _error(tsched.validate_order, order, s, m)
        assert got is not None and got == _error(jsched.validate_order,
                                                 order, s, m)
    bad = [[Op(0, "bwd", 0), Op(0, "fwd", 0)],
           [Op(1, "fwd", 0), Op(1, "bwd", 0)]]
    got = _error(tsched.merge_stage_ops, bad)
    assert "deadlock" in got and got == _error(jsched.merge_stage_ops, bad)
    for args, kw in [((0, 2), {}), ((2, 0), {}),
                     ((2, 2), {"extra_inflight": -1})]:
        got = _error(tsched.stage_ops_1f1b, *args, **kw)
        assert got is not None
        assert got == _error(jsched.stage_ops_1f1b, *args, **kw)
    got = _error(tsched.edge_link_classes, 4, 3)
    assert "must divide" in got
    assert got == _error(jsched.edge_link_classes, 4, 3)
    with pytest.raises(ValueError, match="issued twice"):
        tsched.simulate([Op(0, "fwd", 0), Op(0, "fwd", 0)], 1, 1,
                        t_fwd=1.0, t_bwd=1.0)


# -- the engine against JAX's -------------------------------------------------

_JAX_PARAMS = {}
_RUNS = {}


def _params():
    if not _JAX_PARAMS:
        params = JModel(JConfig(**KW)).init_params(jax.random.PRNGKey(11))
        _JAX_PARAMS["jax"] = params
        _JAX_PARAMS["np"] = jax.tree_util.tree_map(np.asarray, params)
        _JAX_PARAMS["port"] = gpt_params_from_jax(_JAX_PARAMS["np"],
                                                  GPTConfig(**KW))
    return _JAX_PARAMS


def _data(dp):
    rng = np.random.RandomState(11)
    return (rng.randint(0, KW["vocab_size"], (dp * M * MB, SEQ)),
            rng.randint(0, KW["vocab_size"], (dp * M * MB, SEQ)))


def _jax_serial_grads(eng, grads):
    """JAX's per-stage packed gradients as one serial tree, converted to
    the port's names; also the last stage's embedding replica."""
    layers = []
    for st, g in zip(eng.stages, grads):
        tree = jax.tree_util.tree_map(np.asarray, g)
        layers += list(unpack_from_shard_map(
            st.model, {"layers": tree["layers"]}, n_stages=1)["layers"])
    first, last = eng.stages[0], eng.stages[-1]
    serial = {"layers": layers}
    serial.update(unpack_from_shard_map(
        first.model, {"embedding": jax.tree_util.tree_map(
            np.asarray, grads[0]["embedding"])}, n_stages=1))
    serial.update(unpack_from_shard_map(
        last.model, {"final_layernorm": jax.tree_util.tree_map(
            np.asarray, grads[-1]["final_layernorm"])}, n_stages=1))
    replica = unpack_from_shard_map(
        last.model, {"embedding": jax.tree_util.tree_map(
            np.asarray, grads[-1]["embedding"])}, n_stages=1)
    to_port = {k: v.numpy() for k, v in gpt_params_from_jax(
        serial, GPTConfig(**KW)).items()}
    return to_port, np.asarray(replica["embedding"]["weight"])


def _global(grads, S):
    """The port's per-stage gradients (stage-local names) under the serial
    model's names; the embedding replicas apart."""
    out, replicas = {}, []
    for i, g in enumerate(grads):
        ids = pipeline_layer_ids(KW["num_layers"], S, 1, i)
        for name, t in g.items():
            if name.startswith("layers."):
                j, rest = name[len("layers."):].split(".", 1)
                out[f"layers.{ids[int(j)]}.{rest}"] = t.numpy()
            elif name == "embedding.weight":
                replicas.append(t)
                out.setdefault(name, t.numpy())
            else:
                out[name] = t.numpy()
    return out, replicas


def _port_engine(layout, schedule, **kw):
    dp, pp, pods = layout
    return MpmdPipeline(KW, _params()["port"],
                        ParallelPlan(dp=dp, pp=pp, n_microbatches=M,
                                     n_pods=pods),
                        device="cpu", schedule=schedule, **kw)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """The port's ring engine over 2 and 4 gloo ranks (dp 1), started
    first so the ranks run while the JAX engines compile."""
    tokens, targets = _data(1)
    runs = {"dense": dict(cfg=KW, v=1, params="p")}
    params = {"p": _params()["np"]}
    return {S: spawn(tmp_path_factory, S, runs, params,
                     tokens.reshape(M, MB, SEQ),
                     targets.reshape(M, MB, SEQ)) for S in (2, 4)}


def _run(layout):
    if layout not in _RUNS:
        dp, pp, pods = layout
        tokens, targets = _data(dp)
        jeng = JPipeline(KW, _params()["jax"],
                         JPlan(dp=dp, pp=pp, n_microbatches=M, n_pods=pods),
                         devices=jax.devices()[:dp * pp],
                         schedule=JAX_SCHEDULE[layout])
        jloss, jgrads = jeng.loss_and_grads(tokens, targets, step=0)
        want, replica = _jax_serial_grads(jeng, jgrads)
        port = {}
        for name in SCHEDULES:
            eng = _port_engine(layout, name)
            loss, grads = eng.loss_and_grads(torch.from_numpy(tokens),
                                             torch.from_numpy(targets),
                                             step=0)
            port[name] = dict(eng=eng, loss=loss, grads=grads)
        _RUNS[layout] = dict(jeng=jeng, jloss=float(jloss), want=want,
                             replica=replica, port=port, tokens=tokens,
                             targets=targets)
    return _RUNS[layout]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: "dp%d-pp%d-pods%d"
                         % t)
def test_engine_matches_jax(rings, layout, schedule):
    run = _run(layout)
    got = run["port"][schedule]
    _close(float(got["loss"]), run["jloss"])
    grads, replicas = _global(got["grads"], layout[1])
    assert set(grads) == set(run["want"])
    for name, want in run["want"].items():
        _close_grad(grads[name], want, msg=name)
    # JAX's two replicas agree bit for bit, and so do the port's
    np.testing.assert_array_equal(run["replica"],
                                  run["want"]["embedding.weight"])
    assert len(replicas) == 2 and torch.equal(replicas[0], replicas[1])
    assert set(got["grads"][0]) == set(got["eng"].stages[0].state)
    assert set(got["grads"][-1]) == set(got["eng"].stages[-1].state)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: "dp%d-pp%d-pods%d"
                         % t)
def test_schedules_agree_bit_for_bit(layout):
    """Both schedules accumulate in ascending micro-batch order: the same
    loss and gradients bit for bit."""
    a, b = (_run(layout)["port"][s] for s in SCHEDULES)
    assert torch.equal(a["loss"], b["loss"])
    for ga, gb in zip(a["grads"], b["grads"]):
        assert set(ga) == set(gb)
        for name in ga:
            assert torch.equal(ga[name], gb[name]), name


@pytest.mark.parametrize("S", [2, 4])
def test_dp1_bit_for_bit_the_ring_engine(rings, S):
    """At dp 1 the MPMD engine is the port's ``pipeline_step`` at the same
    stage count, bit for bit: the same stage programs, the same ascending
    accumulation, and the channel moves bytes verbatim."""
    ranks = rings[S].result()
    got = _run((1, S, 2))["port"]["1f1b"]
    for r, rank in enumerate(ranks):
        ring = rank["pipeline"]["dense"]
        assert ring["stage"] == r
        assert ring["losses"][0] == float(got["loss"])
        mine = got["grads"][r]
        for name, g in mine.items():
            np.testing.assert_array_equal(g.numpy(), ring["grads"][name],
                                          err_msg=f"stage {r} {name}")


# -- one train step, the fault, the traces, checkpoints -----------------------

@pytest.fixture(scope="module")
def stepped():
    """(2, 2, 2) with dcn_hiding, a scheduled dcn_fault at step 0 and
    tracing: the port's loss_and_grads at step 0 (the fault drops its
    first DCN send), then one train_step (traced as step 1); JAX's
    engine of the same layout takes its train_step with the same fault."""
    run = _run((2, 2, 2))
    tokens, targets = run["tokens"], run["targets"]
    jeng = run["jeng"]
    jinj = JInjector([JFault(0, "dcn_fault")])
    jeng.channel.fault_injector = jinj
    jloss = float(jeng.train_step(tokens, targets))
    inj = FaultInjector([Fault(0, "dcn_fault")])
    eng = _port_engine((2, 2, 2), "dcn_hiding", fault_injector=inj,
                       trace=True)
    before = [{k: v.detach().clone() for k, v in st.state.items()}
              for st in eng.stages]
    loss0, grads0 = eng.loss_and_grads(torch.from_numpy(tokens),
                                       torch.from_numpy(targets), step=0)
    loss = eng.train_step(torch.from_numpy(tokens),
                          torch.from_numpy(targets), step=1)
    return dict(jeng=jeng, jinj=jinj, jloss=jloss, eng=eng, inj=inj,
                loss0=loss0, loss=loss, before=before, grads0=grads0,
                tokens=tokens, targets=targets)


def test_train_step_matches_jax(stepped):
    """One Adam step (lr 1e-3) against JAX's: the loss, and the parameters
    after it within rtol 1e-5 / atol 1e-6 where the gradient is at least
    1e-4 of its tensor's largest (``tests/test_torch_tensor_parallel.py``'s
    rule: at step 1 Adam moves an entry by lr · g / (|g| + eps), so a
    rounding-level gradient's sign decides its lr-sized move); both
    embedding replicas bit for bit equal after the step."""
    eng, jeng = stepped["eng"], stepped["jeng"]
    assert torch.equal(stepped["loss"], stepped["loss0"])
    _close(float(stepped["loss"]), stepped["jloss"])
    want, _ = _jax_serial_grads(jeng, [
        {k: st.state[k] for k in st.state_keys} for st in jeng.stages])
    after, replicas = _global([{k: v.detach() for k, v in st.state.items()}
                               for st in eng.stages], 2)
    before, _ = _global(stepped["before"], 2)
    grads, _ = _global(stepped["grads0"], 2)
    for name, w in want.items():
        g = np.abs(grads[name])
        held = g >= 1e-4 * g.max()
        assert held.mean() > 0.5, name
        assert not np.array_equal(after[name], before[name]), name
        _close(after[name][held], w[held], msg=name)
    assert torch.equal(replicas[0], replicas[1])


def test_scheduled_dcn_fault_is_retried_once(stepped):
    assert stepped["eng"].channel.retries == 1
    assert stepped["inj"].log == [(0, "dcn_fault")]
    assert stepped["jeng"].channel.retries == 1
    assert stepped["jinj"].log == stepped["inj"].log


def test_flow_chains_unbroken(stepped):
    cont = stepped["eng"].collector().continuity()
    assert not cont["broken"] and not cont["orphans"]
    # two steps traced (loss_and_grads at 0, train_step at 1): M + 1
    # chains each
    assert len(cont["complete"]) == 2 * (M + 1)


def _opt_leaves(st):
    from apex_tpu_torch.resilience.checkpoint import tree_flatten
    return [t.clone() for t in tree_flatten(
        st.checkpoint_state()["opt"])[0]]


def test_checkpoint_kill_one_stage(stepped, tmp_path):
    eng = stepped["eng"]
    root = os.path.join(tmp_path, "ckpt")
    eng.save_checkpoint(root, step=1)
    assert os.path.exists(os.path.join(root, MPMD_PLAN_FILE))
    saved = [{k: v.clone() for k, v in st.state.items()}
             for st in eng.stages]
    saved_opt = [_opt_leaves(st) for st in eng.stages]
    eng.train_step(torch.from_numpy(stepped["tokens"]),
                   torch.from_numpy(stepped["targets"]), step=2)
    moved = eng.stages[1].state["layers.0.attention.qkv.weight"].clone()
    assert not torch.equal(moved, saved[1]["layers.0.attention.qkv.weight"])
    assert eng.restore_stage(0, root) == 1
    for k, v in eng.stages[0].state.items():
        assert torch.equal(v, saved[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(_opt_leaves(eng.stages[0]),
                                                  saved_opt[0]))
    # the surviving stage keeps its live state
    assert torch.equal(eng.stages[1].state["layers.0.attention.qkv.weight"],
                       moved)
    assert eng.restore_checkpoint(root) == 1 and eng.step_count == 1
    for st, want, want_opt in zip(eng.stages, saved, saved_opt):
        for k, v in st.state.items():
            assert torch.equal(v, want[k]), k
        got_opt = _opt_leaves(st)
        assert len(got_opt) == len(want_opt)
        assert all(torch.equal(a, b) for a, b in zip(got_opt, want_opt))


def test_checkpoint_plan_stamp_mismatch(stepped, tmp_path):
    eng = stepped["eng"]
    root = os.path.join(tmp_path, "stamp")
    eng.save_checkpoint(root, step=0)
    with open(os.path.join(root, MPMD_PLAN_FILE)) as f:
        doc = json.load(f)
    doc["plan"]["n_microbatches"] = 64
    with open(os.path.join(root, MPMD_PLAN_FILE), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="saved under cross-pod plan"):
        eng.restore_checkpoint(root)
    with pytest.raises(ValueError, match="saved under cross-pod plan"):
        eng.restore_stage(1, root)


@pytest.mark.parametrize("layout", [(2, 2, 2), (1, 4, 2)],
                         ids=lambda t: "dp%d-pp%d-pods%d" % t)
def test_plan_stamp_equals_jax(layout, tmp_path):
    run = _run(layout)
    run["jeng"].save_checkpoint(str(tmp_path / "jax"), step=0)
    run["port"]["1f1b"]["eng"].save_checkpoint(str(tmp_path / "port"),
                                               step=0)
    docs = [(tmp_path / d / MPMD_PLAN_FILE).read_text()
            for d in ("jax", "port")]
    assert docs[0] == docs[1]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


# -- refusals -----------------------------------------------------------------

def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    raise AssertionError("no error")


def test_engine_refusals_match_jax():
    jp, tp = _params()["jax"], _params()["port"]
    cases = [
        (dict(dp=2), {}),
        (dict(pp=2, n_microbatches=2, n_pods=2), {"schedule": "zigzag"}),
        (dict(pp=2, n_microbatches=2, n_virtual=2), {}),
        (dict(pp=3, n_microbatches=2, n_pods=3), {}),
    ]
    for plan_kw, kw in cases:
        want = _message(lambda: JPipeline(KW, jp, JPlan(**plan_kw), **kw))
        got = _message(lambda: MpmdPipeline(KW, tp, ParallelPlan(**plan_kw),
                                            device="cpu", **kw))
        assert got == want
    eng = _port_engine((2, 2, 2), "1f1b")
    with pytest.raises(ValueError, match=r"must be dp\*M\*microbatch"):
        eng.loss_and_grads(torch.zeros((7, SEQ), dtype=torch.long),
                           torch.zeros((7, SEQ), dtype=torch.long))
    with pytest.raises(ValueError, match="one device a stage"):
        MpmdPipeline(KW, tp, ParallelPlan(pp=2, n_microbatches=2,
                                          n_pods=2), devices=["cpu"])
    with pytest.raises(RuntimeError, match="last stage's forward"):
        eng.stages[-1].run_fwd([], 0)


def test_stage_refusals():
    """MoE and TP without SP as JAX refuses them (its messages); TP with
    SP is not ported (one process a shard)."""
    cfg = GPTConfig(n_experts=2, **KW)
    with pytest.raises(ValueError, match="does not support MoE"):
        StageProgram(cfg, {}, stage_index=0, n_stages=2, n_microbatches=2,
                     plan=ParallelPlan(), device="cpu")
    cfg = GPTConfig(tensor_parallel_size=2, axis_name="model", **KW)
    with pytest.raises(ValueError, match="require\\s+sequence_parallel"):
        StageProgram(cfg, {}, stage_index=0, n_stages=2, n_microbatches=2,
                     plan=ParallelPlan(tp=2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        MpmdPipeline(KW, None, ParallelPlan(tp=2, sequence_parallel=True,
                                            pp=2, n_microbatches=2,
                                            n_pods=2), device="cpu")


def test_devices_default_to_the_card():
    """``device`` defaults to ``"cuda"``: without a card the engine raises
    (no fallback to the CPU); ``devices`` places each stage."""
    plan = ParallelPlan(pp=2, n_microbatches=2, n_pods=2)
    if torch.cuda.is_available():
        eng = MpmdPipeline(KW, None, plan)
        assert [st.device.type for st in eng.stages] == ["cuda", "cuda"]
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            MpmdPipeline(KW, None, plan)
    eng = MpmdPipeline(KW, None, plan, devices=["cpu", "cpu"])
    assert [st.device.type for st in eng.stages] == ["cpu", "cpu"]
    assert [st.state_keys for st in eng.stages] == [
        ["embedding", "layers"], ["layers", "final_layernorm", "embedding"]]
