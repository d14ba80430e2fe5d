"""apex_tpu_torch.amp against apex_tpu.amp on the CPU: the opt-level
properties, the O2/O3 parameter cast on a tiny BERT (the same leaves stay
f32), the loss scaler's update rule over a scripted overflow sequence
(equal, field by field), and ``unscale_step``'s device-side skip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.bert import BertModel as JBertModel
from apex_tpu.optimizers import FusedLAMB as JFusedLAMB

from apex_tpu_torch import amp
from apex_tpu_torch.amp.frontend import _opt_level_properties
from apex_tpu_torch.convert import fused_lamb_state_from_jax
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedLAMB

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=32, fused_lm_head=False)
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
       jnp.float16: torch.float16, None: None}


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("half", ["bf16", "f16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_properties_match_jax(level, half):
    jhalf, thalf = ((jnp.bfloat16, torch.bfloat16) if half == "bf16"
                    else (jnp.float16, torch.float16))
    want = jamp.frontend._opt_level_properties(level, jhalf)._asdict()
    got = _opt_level_properties(level, thalf)._asdict()
    jdt = want.pop("cast_model_type")
    assert got.pop("cast_model_type") == (
        None if jdt is None else _DT[jnp.dtype(jdt).type])
    assert got == want


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_cast_params_matches_jax_on_tiny_bert(level):
    """The dtype of every leaf after the cast equals JAX's (O2 keeps the
    normalization leaves f32 by the same name pattern; O3 casts all)."""
    jmodel = JBertModel(JBertConfig(**TINY))
    jstate = jamp.initialize(jmodel.loss, None, opt_level=level)
    jcast = jstate.cast_params(jmodel.init_params(jax.random.PRNGKey(0)))
    want = {n: _DT[jnp.dtype(a.dtype).type] for n, a in _names(jcast)}
    model = BertModel(BertConfig(**TINY), device="cpu")
    state = amp.initialize(model, None, opt_level=level)
    got = {n: p.dtype for n, p in model.named_parameters()}
    assert got == want
    assert state.model is model
    f32 = {n for n, d in got.items() if d == torch.float32}
    if level == "O2":
        assert f32 and all("layernorm" in n for n in f32)
    else:
        assert not f32
    x = torch.ones(3)
    assert state.cast_inputs(x, 5)[0].dtype == torch.bfloat16


def test_initialize_refuses_o1_and_sets_masters():
    """O1 no longer raises (it refused until the autocast was ported): it
    keeps the model f32 and wraps ``forward`` in the autocast, so a linear
    layer's product comes back in bf16; ``patch_torch_functions=True`` does
    the same at O2.  O2 sets the optimizer's masters."""
    model = nn.Linear(2, 2)
    opt = FusedLAMB(model.parameters())
    o1 = amp.initialize(model, opt, opt_level="O1")
    assert o1.properties.patch_torch_functions and not opt.master_weights
    assert model.weight.dtype == torch.float32
    assert model(torch.ones(3, 2)).dtype == torch.bfloat16
    patched = nn.Linear(2, 2)
    amp.initialize(patched, None, opt_level="O2", patch_torch_functions=True)
    assert patched(torch.ones(3, 2, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
    model = nn.Linear(2, 2)
    opt = FusedLAMB(model.parameters())
    state = amp.initialize(model, opt, opt_level="O2")
    assert opt.master_weights and state.scaler.device.type == "cpu"
    assert not state.scaler.dynamic and float(state.scaler.loss_scale) == 1.0
    assert model.weight.dtype == torch.bfloat16
    masters = list(amp.master_params(opt))
    assert [m.dtype for m in masters] == [torch.float32] * 2
    assert torch.equal(masters[0], model.weight.float())
    fp16 = amp.initialize(nn.Linear(2, 2), None, opt_level="O2",
                          half_dtype=torch.float16)
    assert fp16.scaler.dynamic


@pytest.mark.parametrize("dynamic", [True, False])
def test_loss_scaler_update_matches_jax(dynamic):
    """A scripted found-inf sequence: halving, growth after every
    ``scale_window`` clean steps, the min/max clamps and the counters."""
    kw = dict(loss_scale="dynamic" if dynamic else 128.0, init_scale=8.0,
              scale_factor=2.0, scale_window=3, min_loss_scale=2.0,
              max_loss_scale=32.0)
    jscaler = jamp.LossScaler(**kw)
    jstate = jscaler.init()
    scaler = amp.LossScaler(device="cpu", **kw)
    seq = [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 0]
    for f in seq:
        jstate = jscaler.update(jstate, jnp.float32(f))
        scaler.update(torch.tensor(float(f)))
        assert scaler.state_dict() == jscaler.state_dict(jstate)
    assert scaler.state_dict()["skipped"] == sum(seq)
    saved = scaler.state_dict()
    other = amp.LossScaler(device="cpu", **kw)
    other.load_state_dict(saved)
    assert other.state_dict() == saved


def test_scale_unscale_and_found_inf_match_jax():
    jscaler = jamp.LossScaler(init_scale=1024.0)
    jstate = jscaler.init()
    scaler = amp.LossScaler(init_scale=1024.0, device="cpu")
    g = [np.array([1.0, 2048.0, -3.0], np.float32),
         np.array([[0.5, 4.0]], np.float32)]
    jout, jf = jscaler.unscale([jnp.asarray(a) for a in g], jstate)
    out, f = scaler.unscale([torch.from_numpy(a) for a in g])
    assert float(f) == float(jf) == 0.0
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(amp.scale_loss(torch.tensor(2.0), scaler)) == 2048.0
    g[1][0, 1] = np.inf
    assert float(amp.LossScaler.found_inf([torch.from_numpy(a) for a in g])
                 ) == float(jamp.LossScaler.found_inf(
                     [jnp.asarray(a) for a in g])) == 1.0


def test_unscale_step_skips_on_overflow_and_matches_jax():
    """Dynamic scale under O2 masters: a step with an inf gradient is
    skipped on the device (masters, moments, step count and the bf16
    parameters unchanged bit for bit; the scale halves), then a clean step
    matches JAX's ``unscale_step`` (f32 masters and moments to 1e-6)."""
    rng = np.random.RandomState(0)
    w0 = np.asarray(jnp.asarray(rng.randn(4, 3), jnp.bfloat16), np.float32)
    b0 = rng.randn(3).astype(np.float32)
    jparams = {"layernorm": jnp.asarray(b0),
               "w": jnp.asarray(w0, jnp.bfloat16)}
    kw = dict(lr=1e-2, weight_decay=0.01)
    jopt = JFusedLAMB(bucketed=False, master_weights=True, **kw)
    jscaler = jamp.LossScaler(init_scale=4.0)
    jsc = jscaler.init()
    jstate = jopt.init(jparams)

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.layernorm = nn.Parameter(torch.from_numpy(b0.copy()))
            self.w = nn.Parameter(torch.from_numpy(w0.copy()))

    model = M()
    opt = FusedLAMB(model.parameters(), **kw)
    state = amp.initialize(model, opt, opt_level="O2", loss_scale="dynamic")
    assert state.scaler.dynamic
    scaler = amp.LossScaler(init_scale=4.0, device="cpu")
    assert model.w.dtype == torch.bfloat16
    assert model.layernorm.dtype == torch.float32
    grads = [rng.randn(3).astype(np.float32) * 4,
             np.asarray(jnp.asarray(rng.randn(4, 3) * 4, jnp.bfloat16),
                        np.float32)]
    bad = [g.copy() for g in grads]
    bad[1][2, 1] = np.inf
    for step, gs in enumerate((bad, grads)):
        jg = {"layernorm": jnp.asarray(gs[0]),
              "w": jnp.asarray(gs[1], jnp.bfloat16)}
        jparams, jstate, jsc, jf = jamp.unscale_step(
            jopt, jg, jparams, jstate, jscaler, jsc)
        model.layernorm.grad = torch.from_numpy(gs[0].copy())
        model.w.grad = torch.from_numpy(gs[1].copy()).bfloat16()
        if step == 0:
            opt._state(model.w)      # the masters exist before the skip
            before = {k: v.clone() for k, v in opt.state[model.w].items()}
            w_before = model.w.detach().clone()
        f = amp.unscale_step(opt, scaler)
        assert float(f) == float(jf) == (1.0 if step == 0 else 0.0)
        assert scaler.state_dict() == jscaler.state_dict(jsc)
        if step == 0:
            for k, v in opt.state[model.w].items():
                assert torch.equal(v, before[k]), k
            assert torch.equal(model.w, w_before)
            assert int(opt.param_groups[0]["step"]) == 0
            assert float(scaler.loss_scale) == 2.0
    assert int(opt.param_groups[0]["step"]) == int(jstate["step"]) == 1
    carried = fused_lamb_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), model)
    for name, p in model.named_parameters():
        for key, want in carried["state"][name].items():
            np.testing.assert_allclose(opt.state[p][key].numpy(),
                                       want.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        model.w.detach().float().numpy(),
        np.asarray(jparams["w"], np.float32))
