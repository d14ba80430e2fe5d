"""apex_tpu_torch.resilience checkpointing and the guarded step against
apex_tpu's, on the CPU.

* **Checkpoint.**  The port reads a directory the JAX ``CheckpointManager``
  wrote and JAX reads one the port wrote (one process: the same files —
  the manifests' leaf tables and payload sha256 are equal), leaves bit for
  bit, ``topology_of`` / ``plan_of`` equal; the reference's commit-protocol
  cases (corrupt payload falls back, injected corruption, torn and
  manifest-less directories ignored, ``latest`` and retire, empty
  directory raises, async double-buffered); a tensor mutated right after
  ``save_async`` (tensors are mutable: the snapshot happens before the call
  returns); the native host library against its numpy path.
* **Guard.**  A small GPT (2 layers, hidden 64), JAX's weights carried by
  ``convert``, run over the same batches and the same
  ``FaultInjector.from_seed`` schedule (nan grads, inf loss, spikes) and
  rollback setting in both packages: the discrete ``StepResult`` fields
  exactly, ``loss_value`` / ``grad_norm`` to rtol 1e-5, parameters and
  Adam's moments after the run to rtol 1e-5 / atol 1e-6 (at the GPT
  recipe's lr 1e-4: Adam moves an entry whose gradient is at rounding
  level by up to about lr either way); the scaler path
  (an inf loss halves the scale, counted as skipped, and round-trips the
  checkpoint); a clean guarded step bit for bit an unguarded one; the
  misuse errors.
* **O1 and autograd Functions** (``ROADMAP.md`` F2): the small GPT's loss
  and gradients under ``amp.initialize(..., "O1")`` against JAX's O1,
  with JAX's custom-derivative rule applied to the port (bit for bit) and
  three controls that the bounds reject.
"""

import json
import os
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaler as JLossScaler
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel.plan import ParallelPlan as JParallelPlan
from apex_tpu.resilience import (CheckpointManager as JManager,
                                 FaultInjector as JInjector,
                                 GuardedTrainStep as JGuard)
from apex_tpu.resilience.elastic import TopologySpec as JTopologySpec

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.convert import (fused_adam_state_from_jax,
                                    gpt_params_from_jax)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import ParallelPlan
from apex_tpu_torch.resilience import (CheckpointManager, CheckpointNotFound,
                                       Fault, FaultInjector, GuardedTrainStep,
                                       TopologySpec, optimizer_state)
from apex_tpu_torch.utils import native


class Pair(NamedTuple):
    first: object
    second: object


def _state_np(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(5, 3).astype(np.float32),
            "opt": {"step": np.asarray(7, np.int32),
                    "m": [r.randn(4).astype(np.float32),
                          r.randn(2, 2).astype(np.float32)]},
            "pair": Pair(np.asarray(2.5, np.float32),
                         r.randint(0, 9, (3,)).astype(np.int32)),
            "b16": r.randn(6).astype(np.float32)}


def _as_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["b16"] = out["b16"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = {"w": torch.tensor(tree["w"]),
           "opt": {"step": torch.tensor(tree["opt"]["step"]),
                   "m": [torch.tensor(a) for a in tree["opt"]["m"]]},
           "pair": Pair(torch.tensor(tree["pair"].first),
                        torch.tensor(tree["pair"].second)),
           "b16": torch.tensor(tree["b16"]).to(torch.bfloat16)}
    return out


def _flat_np(tree):
    out = []
    for leaf in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
            out.append(leaf.numpy())
        else:
            out.append(np.asarray(jnp.asarray(leaf).astype(jnp.float32)
                                  if leaf.dtype == jnp.bfloat16 else leaf))
    return out


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


# -- checkpoints: the two packages read each other's -------------------------


def test_checkpoints_cross_read_with_jax_bitwise(tmp_path):
    state = _state_np()
    spec, jspec = TopologySpec(dp=2), JTopologySpec(dp=2)
    plan, jplan = ParallelPlan(dp=2, remat=True), \
        JParallelPlan(dp=2, remat=True)
    jm = JManager(str(tmp_path / "jax"), topology=jspec,
                  parallel_plan=jplan)
    tm = CheckpointManager(str(tmp_path / "torch"), topology=spec,
                           parallel_plan=plan)
    jpath = jm.save(3, _as_jax(state))
    tpath = tm.save(3, _as_torch(state))
    jman, tman = _manifest(jpath), _manifest(tpath)
    # the same bytes: equal payload hash, leaf tables and stamps
    for key in ("format", "step", "sha256", "nbytes", "leaves", "topology",
                "mesh_shape", "parallel_plan"):
        assert jman[key] == tman[key], key

    # the port reads JAX's directory, JAX reads the port's
    port_reader = CheckpointManager(str(tmp_path / "jax"))
    got, step = port_reader.restore(_as_torch(_state_np(1)))
    assert step == 3 and got["b16"].dtype == torch.bfloat16
    assert isinstance(got["pair"], Pair)
    jax_reader = JManager(str(tmp_path / "torch"))
    jgot, jstep = jax_reader.restore(_as_jax(_state_np(1)))
    assert jstep == 3 and jgot["b16"].dtype == jnp.bfloat16
    want = _flat_np(_as_torch(state))
    for a, b, c in zip(_flat_np(got), _flat_np(jgot), want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert port_reader.topology_of(3) == jax_reader.topology_of(3) \
        == spec.to_dict()
    assert port_reader.plan_of(3) == jax_reader.plan_of(3) == plan.to_dict()
    # the hash is checked on the way in: a flipped byte falls back
    with open(os.path.join(jpath, "state.bin"), "r+b") as f:
        f.seek(8)
        f.write(b"\x00\x01")
    with pytest.warns(UserWarning, match="corrupt"):
        with pytest.raises(CheckpointNotFound):
            port_reader.restore(_as_torch(state))


# -- the reference's commit-protocol cases ------------------------------------


def test_corrupt_payload_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"a": torch.arange(4.0)})
    path2 = mgr.save(2, {"a": torch.arange(4.0) + 100.0})
    with open(os.path.join(path2, "state.bin"), "r+b") as f:
        f.seek(4)
        f.write(b"\xff\xff\xff\xff")
    with pytest.warns(UserWarning, match="corrupt"):
        restored, step = mgr.restore({"a": torch.zeros(4)})
    assert step == 1
    assert torch.equal(restored["a"], torch.arange(4.0))


def test_injected_corruption(tmp_path):
    inj = FaultInjector([Fault(step=2, kind="corrupt_checkpoint")])
    mgr = CheckpointManager(str(tmp_path), keep=3, fault_injector=inj)
    mgr.save(1, {"a": torch.arange(6.0)})
    mgr.save(2, {"a": torch.arange(6.0) * 2})
    assert (2, "corrupt_checkpoint") in inj.log
    with pytest.warns(UserWarning, match="corrupt"):
        _, step = mgr.restore({"a": torch.zeros(6)})
    assert step == 1


def test_torn_and_manifestless_dirs_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000007.tmp")
    (tmp_path / "step_00000007.tmp" / "state.bin").write_bytes(b"xx")
    os.makedirs(tmp_path / "step_00000009")
    (tmp_path / "step_00000009" / "state.bin").write_bytes(b"yy")
    assert mgr.all_steps() == [3]
    _, step = mgr.restore({"a": torch.zeros(2)})
    assert step == 3


def test_latest_symlink_and_retire(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": torch.full((2,), float(s))})
    assert os.readlink(tmp_path / "latest") == "step_00000003"
    assert mgr.all_steps() == [2, 3]
    assert mgr.last_save["bytes"] == 8 and mgr.last_save["seconds"] > 0


def test_empty_dir_raises(tmp_path):
    with pytest.raises(CheckpointNotFound):
        CheckpointManager(str(tmp_path)).restore({"a": torch.zeros(2)})


def test_async_double_buffered(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=4)
    states = [{"a": torch.full((3,), float(s))} for s in range(3)]
    for s, st in enumerate(states):
        mgr.save_async(s, st)
    mgr.wait()
    assert mgr.all_steps() == [0, 1, 2]
    restored, step = mgr.restore({"a": torch.zeros(3)})
    assert step == 2 and torch.equal(restored["a"], states[2]["a"])


def test_manager_host_buffers_reused_and_bounded(monkeypatch):
    """A manager's page-locked buffers (CUDA state only; the lock is
    stubbed here): one of the size asked is reused, by identity, among
    buffers of other sizes; at most the newest two are kept."""
    from apex_tpu_torch.resilience import checkpoint as ck
    empty = torch.empty
    monkeypatch.setattr(ck.torch, "empty", lambda *a, pin_memory=False,
                        **k: empty(*a, **k))
    bufs = ck._HostBuffers()
    assert bufs.take(8, False)[1] is None
    owners = [bufs.take(n, True)[1] for n in (8, 16, 24)]
    for owner in owners:
        bufs.give(owner)
    assert bufs.take(16, True)[1] is owners[1]
    assert bufs.take(24, True)[1] is owners[2]
    assert bufs.take(8, True)[1] is not owners[0]     # the oldest went


def test_save_async_snapshots_before_returning(tmp_path):
    """Tensors are mutable: an in-place update right after ``save_async``
    (the next optimizer step) must not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    big = torch.arange(1 << 20, dtype=torch.float32)
    want = big.clone()
    mgr.save_async(1, {"p": big, "step": torch.tensor(1)})
    big.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore({"p": torch.zeros(1), "step": torch.tensor(0)})
    assert torch.equal(restored["p"], want)


@pytest.mark.parametrize("mode", ["native", "numpy"])
def test_native_host_library_against_its_numpy_path(mode, tmp_path,
                                                    monkeypatch):
    if mode == "native":
        assert native.lib() is not None, "g++ could not build the library"
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    r = np.random.RandomState(2)
    arrs = [r.randn(300_000).astype(np.float32),
            r.randint(0, 100, (5,)).astype(np.int64),
            r.randn(2, 2).astype(np.float16)]
    buf = native.pack(arrs)
    assert np.array_equal(buf, np.concatenate(
        [a.view(np.uint8).reshape(-1) for a in arrs]))
    outs = [np.empty_like(a) for a in arrs]
    native.unpack(buf, outs)
    for a, o in zip(arrs, outs):
        np.testing.assert_array_equal(a, o)
    big = np.random.RandomState(3).randint(0, 255, 9 << 20).astype(np.uint8)
    path = str(tmp_path / "blob.bin")
    native.file_write(path, big, threads=4)
    np.testing.assert_array_equal(native.file_read(path, threads=4), big)


# -- the guarded step against JAX's ------------------------------------------

GPT = dict(vocab_size=64, hidden_size=64, num_layers=2,
           num_attention_heads=4, max_seq_len=16, fused_lm_head=False)
LR = 1e-4                       # phase 5's FusedAdam(lr=1e-4)
N_STEPS = 10
RATES = {"nan_grads": 0.12, "inf_loss": 0.12, "grad_spike": 0.2}
GUARD_KW = dict(warmup_steps=2, spike_factor=10.0, max_consecutive=2)


def _gpt_batch(step):
    r = np.random.RandomState(500 + step)
    return (r.randint(0, GPT["vocab_size"], (2, 16)),
            r.randint(0, GPT["vocab_size"], (2, 16)))


def _jax_init():
    model = JModel(JConfig(**GPT))
    return model, model.init_params(jax.random.PRNGKey(4))


def _port_model(params):
    cfg = GPTConfig(**GPT)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _result_fields(res):
    return (res.skipped, res.anomaly, res.next_step, res.rolled_back,
            res.restored_from)


def _run_jax_guard(tmp_path, scaler=False):
    model, params = _jax_init()
    opt = JFusedAdam(lr=LR, bucketed=False)
    inj = JInjector.from_seed(11, N_STEPS, RATES)
    jscaler = JLossScaler("dynamic", init_scale=2.0 ** 8) if scaler else None
    guard = JGuard(lambda p, x, y: model.loss(p, x, y), opt,
                   checkpoint=JManager(str(tmp_path / "jg")),
                   fault_injector=inj, scaler=jscaler, **GUARD_KW)
    state, gstate = opt.init(params), guard.init_state()
    sstate = jscaler.init() if scaler else None
    guard.save(0, params, state, gstate, sstate)
    out, step, calls = [], 0, 0
    while step < N_STEPS and calls < 2 * N_STEPS:
        x, y = _gpt_batch(step)
        res = guard(params, state, gstate, jnp.asarray(x), jnp.asarray(y),
                    scaler_state=sstate, step=step)
        params, state, gstate = res.params, res.opt_state, res.guard_state
        sstate = res.scaler_state
        out.append(res)
        step, calls = res.next_step, calls + 1
        if step % 3 == 0 and not res.rolled_back:
            guard.save(step, params, state, gstate, sstate)
    return inj, out, params, state, gstate, sstate


def _run_port_guard(tmp_path, init, scaler=False):
    model = _port_model(init)
    opt = FusedAdam(model.parameters(), lr=LR)
    inj = FaultInjector.from_seed(11, N_STEPS, RATES)
    tscaler = (LossScaler("dynamic", init_scale=2.0 ** 8, device="cpu")
               if scaler else None)
    guard = GuardedTrainStep(lambda m, x, y: m.loss(x, y), opt,
                             checkpoint=CheckpointManager(
                                 str(tmp_path / "tg")),
                             fault_injector=inj, scaler=tscaler, **GUARD_KW)
    gstate = guard.init_state()
    guard.save(0, model, gstate)
    out, step, calls = [], 0, 0
    while step < N_STEPS and calls < 2 * N_STEPS:
        x, y = (torch.from_numpy(a) for a in _gpt_batch(step))
        res = guard(model, gstate, x, y, step=step)
        gstate = res.guard_state
        out.append(res)
        step, calls = res.next_step, calls + 1
        if step % 3 == 0 and not res.rolled_back:
            guard.save(step, model, gstate)
    return inj, out, model, opt, gstate, tscaler


_GUARD_RUNS = {}


def _guard_runs(tmp_path_factory, scaler=False):
    if scaler not in _GUARD_RUNS:
        tmp = tmp_path_factory.mktemp(f"guard_{scaler}")
        jrun = _run_jax_guard(tmp, scaler)
        init = _jax_init()[1]
        _GUARD_RUNS[scaler] = (jrun, _run_port_guard(tmp, init, scaler))
    return _GUARD_RUNS[scaler]


@pytest.mark.parametrize("scaler", [False, True], ids=["plain", "scaler"])
def test_guard_step_results_match_jax(scaler, tmp_path_factory):
    (jinj, jout, *_), (tinj, tout, *_) = _guard_runs(tmp_path_factory,
                                                     scaler)
    assert [(f.step, f.kind) for f in tinj.schedule] == \
        [(f.step, f.kind) for f in jinj.schedule]
    assert tinj.log == jinj.log
    assert [_result_fields(r) for r in tout] == \
        [_result_fields(r) for r in jout]
    kinds = {r.anomaly for r in tout}
    assert {"nonfinite", "spike", None} <= kinds     # non-vacuous
    assert any(r.rolled_back for r in tout)
    for t, j in zip(tout, jout):
        for a, b in ((t.loss_value, j.loss_value),
                     (t.grad_norm, j.grad_norm)):
            if np.isfinite(b):
                assert a == pytest.approx(b, rel=1e-5)
            else:
                assert not np.isfinite(a)
        assert t.loss_scale_value == j.loss_scale_value


@pytest.mark.parametrize("scaler", [False, True], ids=["plain", "scaler"])
def test_guard_final_state_matches_jax(scaler, tmp_path_factory):
    (_, jout, jparams, jstate, jg, js), (_, _, model, opt, tg, ts) = \
        _guard_runs(tmp_path_factory, scaler)
    want = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               GPTConfig(**GPT))
    carried = fused_adam_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), model)
    assert int(opt.param_groups[0]["step"]) == carried["step"]
    clean, n_live, n_all = carried["step"], 0, 0
    for name, p in model.named_parameters():
        for slot in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                opt.state[p][slot].numpy(),
                carried["state"][name][slot].numpy(), rtol=1e-5, atol=1e-6,
                err_msg=f"{name} {slot}")
        # Adam normalizes each entry's step: where the gradient is at
        # rounding level (the key bias, which softmax ignores) the two
        # sums' noise moves the entry by up to ~lr either way, so the
        # parameters are held at 1e-5 / 1e-6 where sqrt(v) is at least
        # 1e-4 of the tensor's largest, and elsewhere within 4.5 lr a
        # clean step (the bound of test_torch_gpt_training)
        rms = np.sqrt(carried["state"][name]["exp_avg_sq"].numpy())
        live = rms >= 1e-4 * rms.max()
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got[live], ref[live], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - ref)[~live].max(initial=0.0) <= 4.5 * LR * clean
        n_live, n_all = n_live + live.sum(), n_all + live.size
    assert n_live >= 0.99 * n_all
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)
    if scaler:
        assert float(ts.loss_scale) == float(js.loss_scale)
        assert int(ts.skipped) == int(js.skipped) > 0


def test_scaler_skip_and_checkpoint_roundtrip(tmp_path):
    """The reference case: an injected inf loss counts as an overflow
    (scale halves, skipped increments) and the scaler state round-trips
    through the checkpoint."""
    model = _port_model(_jax_init()[1])
    scaler = LossScaler("dynamic", init_scale=2.0 ** 8, device="cpu")
    guard = GuardedTrainStep(
        lambda m, x, y: m.loss(x, y), FusedAdam(model.parameters(), lr=LR),
        scaler=scaler, fault_injector=FaultInjector(
            [Fault(step=1, kind="inf_loss")]))
    gstate = guard.init_state()
    for step in range(2):
        x, y = (torch.from_numpy(a) for a in _gpt_batch(step))
        gstate = guard(model, gstate, x, y, step=step).guard_state
    assert float(scaler.loss_scale) == 2.0 ** 7
    assert int(scaler.skipped) == 1
    assert guard.stats["scaler_skipped_steps"] == 1
    guard.checkpoint = CheckpointManager(str(tmp_path))
    guard.save(2, model, gstate)
    scaler.loss_scale.fill_(3.0)
    scaler.skipped.fill_(0)
    restored, _ = guard.checkpoint.restore(guard._template(model, gstate))
    guard.load_state(model, restored)
    assert float(scaler.loss_scale) == 2.0 ** 7 and int(scaler.skipped) == 1


def test_clean_guarded_step_is_bitwise_an_unguarded_step():
    init = _jax_init()[1]
    ref, model = _port_model(init), _port_model(init)
    ref_opt = FusedAdam(ref.parameters(), lr=LR)
    guard = GuardedTrainStep(lambda m, x, y: m.loss(x, y),
                             FusedAdam(model.parameters(), lr=LR))
    gstate = guard.init_state()
    for step in range(3):
        x, y = (torch.from_numpy(a) for a in _gpt_batch(step))
        ref_opt.zero_grad()
        ref.loss(x, y).backward()
        ref_opt.step()
        res = guard(model, gstate, x, y, step=step)
        gstate = res.guard_state
        assert not res.skipped
    for (n, a), b in zip(ref.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n
    want = optimizer_state(ref_opt)["groups"][0]
    got = res.opt_state["groups"][0]
    assert torch.equal(want["step"], got["step"])
    for a, b in zip(want["state"], got["state"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_misuse_raises():
    model = _port_model(_jax_init()[1])
    opt = FusedAdam(model.parameters(), lr=LR)
    with pytest.raises(ValueError, match="exactly one"):
        GuardedTrainStep(lambda m: 0, opt, grad_fn=lambda m: 0)
    with pytest.raises(ValueError, match="optimizer is required"):
        GuardedTrainStep(lambda m: 0)
    with pytest.raises(ValueError, match="scaler requires"):
        GuardedTrainStep(grad_fn=lambda m: 0, optimizer=opt,
                         scaler=LossScaler(device="cpu"))
    guard = GuardedTrainStep(lambda m: 0, opt)
    with pytest.raises(ValueError, match="no CheckpointManager"):
        guard.save(1, model, guard.init_state())
    qmodel = torch.nn.Module()
    qmodel.w = torch.nn.Parameter(torch.zeros(2, dtype=torch.int8),
                                  requires_grad=False)
    qguard = GuardedTrainStep(lambda m: 0, FusedAdam(qmodel.parameters()))
    with pytest.raises(ValueError, match="int8"):
        qguard(qmodel, qguard.init_state())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert guard.stats["rollbacks"] == 0


# -- O1 over autograd Functions (ROADMAP.md F2) -------------------------------


# Port Functions the small GPT runs whose JAX counterparts are
# custom-derivative calls at this configuration (the LayerNorms and the
# cross entropy); its attention is a Function in the port but plain dots in
# JAX.
JAX_CUSTOM_CALLS = ("_NormAffine", "_VocabParallelCrossEntropy")
# (loss relative, largest gradient error over the largest entry, gradient
# error in norm over the norm), worst over the parameters.  Readings: the
# port's O1 against JAX's 1.0e-5, 4.7e-3, 3.9e-3; the controls against JAX's
# O1 at least 5.3e-5 or 8.3e-3 or 6.7e-3 (f32: 5.3e-5, 9.2e-3, 9.1e-3; every
# Function bound whole: 2.5e-5, 9.5e-3, 6.7e-3; O3: 5.3e-6, 8.3e-3, 7.0e-3).
O1_BOUNDS = (3e-5, 6e-3, 5e-3)


def _o1_port(params, level, bind_whole=()):
    """Loss and gradients of the port's small GPT under ``amp.initialize``
    at ``level`` (None: plain f32).  The autograd Functions named in
    ``bind_whole`` (or every one, for ``"all"``) run as JAX's O1
    interpreter runs a custom-derivative call: floating inputs restored to
    the f32 they have without autocast, the body outside the autocast.
    Returns ``(loss, grads, calls)``, ``calls`` counting the Functions so
    bound."""
    from collections import Counter

    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.interpreter import autocast_dtype

    class LossGPT(GPTModel):
        def forward(self, tokens, targets):
            return self.loss(tokens, targets)

    cfg = GPTConfig(**GPT)
    model = LossGPT(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    if level is not None:
        amp.initialize(model, FusedAdam(model.parameters(), lr=LR),
                       opt_level=level)
    calls = Counter()
    apply = torch.autograd.Function.apply.__func__

    def bound_whole(cls, *args, **kwargs):
        if autocast_dtype() is None or not (
                bind_whole == "all" or cls.__name__ in bind_whole):
            return apply(cls, *args, **kwargs)
        calls[cls.__name__] += 1
        args = tuple(a.float() if isinstance(a, torch.Tensor)
                     and a.is_floating_point() else a for a in args)
        with torch.overrides._pop_mode_temporarily():
            return apply(cls, *args, **kwargs)

    torch.autograd.Function.apply = classmethod(bound_whole)
    try:
        x, y = (torch.from_numpy(a) for a in _gpt_batch(0))
        loss = model(x, y)
        loss.backward()
    finally:
        torch.autograd.Function.apply = classmethod(apply)
    return (float(loss), {n: p.grad.float().numpy()
                          for n, p in model.named_parameters()}, calls)


def _o1_errors(got, want):
    loss = abs(got[0] - want[0]) / abs(want[0])
    worst = max(np.abs(got[1][n] - w).max() / np.abs(w).max()
                for n, w in want[1].items())
    norm = max(np.linalg.norm(got[1][n] - w) / np.linalg.norm(w)
               for n, w in want[1].items())
    return loss, worst, norm


def test_o1_gpt_loss_and_grads_match_jax():
    """The small GPT's loss and every gradient under ``amp.initialize(...,
    "O1")`` against JAX's O1 (``amp.initialize(model.loss, "O1")``), bf16
    compute.  The port's autocast also casts inside an autograd Function's
    forward, where JAX re-binds a custom-derivative call whole with its
    inputs restored to their traced dtypes (ROADMAP.md F2).  Held three
    ways:

    * JAX's rule applied to the port at JAX's custom-derivative calls
      (``JAX_CUSTOM_CALLS`` bound whole) gives the port's O1 bit for bit:
      those bodies take f32 inputs and run f32-listed ops either way;
    * the port's O1 is within ``O1_BOUNDS`` of JAX's;
    * three controls fall outside them: plain f32 (casts nothing), every
      Function bound whole (the attention's products then run in f32,
      where JAX's plain dots take bf16) and O3 (casts everything)."""
    from apex_tpu import amp as jamp

    jmodel, params = _jax_init()
    x, y = (jnp.asarray(a) for a in _gpt_batch(0))
    state = jamp.initialize(jmodel.loss, opt_level="O1")
    jloss, jgrads = jax.value_and_grad(
        lambda p: state.apply_fn(p, x, y))(params)
    want = (float(jloss), {n: t.numpy() for n, t in gpt_params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jgrads),
        GPTConfig(**GPT)).items()})

    got = _o1_port(params, "O1")
    as_jax = _o1_port(params, "O1", JAX_CUSTOM_CALLS)
    assert as_jax[2] == {"_NormAffine": 5, "_VocabParallelCrossEntropy": 1}
    assert as_jax[0] == got[0]
    for n, g in got[1].items():
        assert np.array_equal(as_jax[1][n], g), n
    errors = _o1_errors(got, want)
    assert all(e <= b for e, b in zip(errors, O1_BOUNDS)), errors
    for name, level, bind in (("f32", None, ()), ("whole", "O1", "all"),
                              ("O3", "O3", ())):
        errors = _o1_errors(_o1_port(params, level, bind), want)
        assert any(e > b for e, b in zip(errors, O1_BOUNDS)), (name, errors)
