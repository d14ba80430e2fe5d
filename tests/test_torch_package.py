"""apex_tpu_torch stands alone: no JAX, nothing of apex_tpu, entry points
that default to the card, kernels that launch only for CUDA tensors, and a
kernel build that reports nvcc's failure."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels, amp
from apex_tpu_torch.inference import InferenceEngine, KVCache, Request
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.normalization import MixedFusedLayerNorm
from apex_tpu_torch.ops.flash_attention import (flash_attention_decode,
                                                flash_attention_dkv,
                                                flash_attention_dq, flash_fwd)
from apex_tpu_torch.ops.fused_ffn import ffn_dw, ffn_dx, ffn_fwd
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
from apex_tpu_torch.ops.lm_head import lm_head_dw, lm_head_dx, lm_head_fwd
from apex_tpu_torch.ops.multi_tensor import (multi_tensor_adagrad,
                                             multi_tensor_adam,
                                             multi_tensor_axpby_,
                                             multi_tensor_lamb_stage1,
                                             multi_tensor_lamb_stage2,
                                             multi_tensor_novograd,
                                             multi_tensor_scale_,
                                             multi_tensor_sgd,
                                             multi_tensor_sumsq)
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedNovoGrad, FusedSGD)
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_no_pipelining)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "apex_tpu_torch"
TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=32)
COUNTERS = (layer_norm_fwd, flash_fwd, flash_attention_decode,
            layer_norm_bwd, flash_attention_dq, flash_attention_dkv,
            multi_tensor_adam, multi_tensor_scale_, multi_tensor_sumsq,
            multi_tensor_lamb_stage1, multi_tensor_lamb_stage2, lm_head_fwd,
            lm_head_dx, lm_head_dw, ffn_fwd, ffn_dx, ffn_dw, multi_tensor_axpby_,
            multi_tensor_sgd, multi_tensor_adagrad, multi_tensor_novograd)
BERT_TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_seq_len=32, fused_lm_head=False)


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_apex_tpu():
    modules = sorted(
        "apex_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        .replace(".__init__", "") for p in PKG.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.rstrip('.'))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'apex_tpu' or m.startswith('apex_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_apex_tpu(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "apex_tpu"), \
                f"{path.name} imports {name}"


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixedFusedLayerNorm(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache(1, 1, 4, 1, 8)
    model = GPTModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
    with pytest.raises(ValueError, match="model on cpu"):
        InferenceEngine(model, device="meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel(BertConfig(**BERT_TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.LossScaler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.initialize(None, None, opt_level="O2")


def test_cpu_serving_launches_no_kernel():
    for c in COUNTERS:
        c.launches = 0
    model = GPTModel(GPTConfig(**TINY), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, max_slots=2, device="cpu")
    for i, n in enumerate((3, 9, 5)):
        engine.submit(Request(request_id=i, prompt=list(range(1, n + 1)),
                              max_new_tokens=3))
    done = engine.run()
    assert sorted(r.finish_reason for r in done) == ["length"] * 3
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_cpu_training_launches_no_kernel():
    """A CPU training step (loss, backward, FusedAdam) takes every
    wrapper's plain version, with the f32-logits head, with the fused LM
    head and with the fused FFN: no counter moves."""
    for c in COUNTERS:
        c.launches = 0
    for fused, ffn in ((False, False), (True, False), (True, True)):
        model = GPTModel(GPTConfig(**TINY, fused_lm_head=fused,
                                   fused_ffn=ffn, attention_dropout=0.1),
                         device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        opt = FusedAdam(model.parameters(), lr=1e-3)
        tokens = torch.randint(0, 64, (2, 1, 16),
                               generator=torch.Generator().manual_seed(1))
        loss = forward_backward_no_pipelining(
            lambda m, x: m.backbone(m.embed(x), dropout_seed=0),
            lambda x, t: model.head_loss(x, t).mean(), model, tokens, tokens)
        opt.step()
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in model.parameters())
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_cpu_bert_o2_lamb_training_launches_no_kernel():
    """A CPU BERT step under O2 (loss, backward, the clip and unscale
    passes, FusedLAMB with masters) takes every wrapper's plain version,
    with and without the fused LM head and the fused FFN."""
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
    for c in COUNTERS:
        c.launches = 0
    for fused, ffn in ((False, False), (True, False), (True, True)):
        model = BertModel(BertConfig(**dict(BERT_TINY, fused_lm_head=fused,
                                            fused_ffn=ffn),
                                     dtype=torch.bfloat16),
                          device="cpu").init_params(
            torch.Generator().manual_seed(0))
        opt = FusedLAMB(model.parameters(), lr=1e-3)
        state = amp.initialize(model, opt, opt_level="O2")
        tokens = torch.randint(0, 64, (2, 1, 16),
                               generator=torch.Generator().manual_seed(1))
        labels = torch.where(tokens % 3 == 0, tokens, -1)
        loss = forward_backward_no_pipelining(
            lambda m, x: x, lambda x, t: model.loss(x, t), model, tokens,
            labels)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        state.scaler.unscale(grads, out=grads)
        clip_grad_norm_(model.parameters(), 1.0)
        opt.step()
        assert torch.isfinite(loss)
        assert all(p.dtype == torch.float32 for p in opt.master_params())
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_cpu_resnet_training_launches_no_kernel():
    """CPU ResNet steps under O1 and O2 with FusedSGD, FusedAdagrad and
    FusedNovoGrad, and the functional axpby, take every wrapper's plain
    version: no counter moves."""
    from apex_tpu_torch.models import resnet26
    from apex_tpu_torch.multi_tensor_apply import multi_tensor_axpby
    for c in COUNTERS:
        c.launches = 0
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1, 3])
    for level, cls in (("O1", FusedSGD), ("O2", FusedAdagrad),
                       ("O1", FusedNovoGrad)):
        model = resnet26(device="cpu", width=8, num_classes=10,
                         dtype=torch.bfloat16 if level == "O2"
                         else torch.float32).init_params(
            torch.Generator().manual_seed(0))
        opt = cls(model.parameters(), lr=1e-2)
        amp.initialize(model, opt, opt_level=level)
        model.loss(x, y).backward()
        opt.step()
        grads = [p.grad for p in model.parameters()]
        multi_tensor_axpby(0.5, grads, 0.5, grads)
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_cuda_wrappers_refuse_what_their_kernels_do_not_take():
    """Argument checks run before any launch, so they hold here too."""
    meta = torch.empty((2, 4, 8, 48), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_fwd(meta, meta, meta, True, 1.0)
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm_fwd(x, torch.ones(8), None, 1e-5, False)


@pytest.mark.parametrize("kernel", ["layer_norm_bwd", "flash_attention_dq",
                                    "flash_attention_dkv",
                                    "multi_tensor_adam", "multi_tensor_scale_",
                                    "multi_tensor_sumsq",
                                    "multi_tensor_lamb_stage1",
                                    "multi_tensor_lamb_stage2",
                                    "lm_head_fwd", "lm_head_dx",
                                    "lm_head_dw", "ffn_fwd", "ffn_dx",
                                    "ffn_dw", "multi_tensor_axpby_",
                                    "multi_tensor_sgd", "multi_tensor_adagrad",
                                    "multi_tensor_novograd"])
def test_training_wrappers_refuse_non_cpu_tensors_they_cannot_launch(kernel):
    """A tensor that is not on the CPU never takes a plain version: the
    new wrappers run their checks and raise before any launch (here on
    the ``meta`` device, which no kernel takes)."""
    meta = torch.empty((2, 4, 8, 16), device="meta")
    stats = torch.empty((8, 8), device="meta")
    x = torch.empty((4, 8), device="meta")
    rows = torch.empty(4, dtype=torch.long, device="meta")
    calls = {
        "layer_norm_bwd": lambda: layer_norm_bwd(
            x, x, torch.ones(8), None, stats, stats, False, False),
        "flash_attention_dq": lambda: flash_attention_dq(
            meta, meta, meta, meta, stats, stats, True, 1.0),
        "flash_attention_dkv": lambda: flash_attention_dkv(
            meta, meta, meta, meta, stats, stats, True, 1.0),
        "multi_tensor_adam": lambda: multi_tensor_adam(
            [x], [x], [x], [x], torch.empty(8, device="meta")),
        "multi_tensor_scale_": lambda: multi_tensor_scale_([x], [x], 2.0),
        "multi_tensor_sumsq": lambda: multi_tensor_sumsq([x]),
        "multi_tensor_lamb_stage1": lambda: multi_tensor_lamb_stage1(
            [x], [x], [x], [x], [x], torch.empty(9, device="meta")),
        "multi_tensor_lamb_stage2": lambda: multi_tensor_lamb_stage2(
            [x], [x], [None], x, x, 1.0),
        "lm_head_fwd": lambda: lm_head_fwd(x, x, rows),
        "lm_head_dx": lambda: lm_head_dx(x, x, rows, rows.float(),
                                         rows.float()),
        "lm_head_dw": lambda: lm_head_dw(x, x, rows, rows.float(),
                                         rows.float()),
        "ffn_fwd": lambda: ffn_fwd(x, x.t(), rows.float()[:4], x),
        "ffn_dx": lambda: ffn_dx(x, x, x.t(), x),
        "ffn_dw": lambda: ffn_dw(x, x, x, x.t(), x),
        "multi_tensor_axpby_": lambda: multi_tensor_axpby_([x], [x], [x],
                                                           1.0, 2.0),
        "multi_tensor_sgd": lambda: multi_tensor_sgd(
            [x], [x], [x], None, torch.empty(5, device="meta")),
        "multi_tensor_adagrad": lambda: multi_tensor_adagrad(
            [x], [x], [x], None, torch.empty(4, device="meta")),
        "multi_tensor_novograd": lambda: multi_tensor_novograd(
            [x], [x], [x], None, torch.empty(1, device="meta"),
            torch.empty(6, device="meta")),
    }
    with pytest.raises(ValueError, match="unsupported device|CUDA device"):
        calls[kernel]()


def test_failed_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake nvcc refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake nvcc refused"):
        _kernels.build()
    name = _kernels.library_path().name
    assert name.startswith("libapex_tpu_torch_") and name.endswith(".so")
    assert _kernels.source_hash() in name


def test_build_dir_is_gitignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert _kernels.BUILD_DIR.relative_to(ROOT).parts[0] == "build"


def test_kernel_dtype_codes_cover_the_served_dtypes():
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert _kernels.dtype_code(torch.empty(0, dtype=dt), "k") in (0, 1, 2)
    with pytest.raises(TypeError, match="not supported"):
        _kernels.dtype_code(torch.empty(0, dtype=torch.float64), "k")
    assert np.unique(list(_kernels.DTYPE_CODES.values())).size == 3


def _c_signatures():
    """argtypes of every ``extern "C"`` entry point, read from the CUDA
    sources (a pointer is c_void_p; int64_t, uint32_t, float and int map
    to their ctypes)."""
    import ctypes
    import re
    src = "".join((_kernels.CSRC / name).read_text()
                  for name in _kernels.SOURCES)
    out = {}
    for m in re.finditer(r'extern "C" \w+\s*\*?\s*(\w+)\(([^)]*)\)', src):
        types = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            if "*" in param:
                types.append(ctypes.c_void_p)
            elif "int64_t" in param:
                types.append(ctypes.c_int64)
            elif "uint32_t" in param:
                types.append(ctypes.c_uint32)
            elif "float" in param:
                types.append(ctypes.c_float)
            else:
                assert param.startswith("int "), param
                types.append(ctypes.c_int)
        out[m.group(1)] = types
    return out


@pytest.mark.parametrize("name", sorted(_kernels._SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    """A wrong argtypes list passes a pointer through a 32-bit int (or the
    reverse) without any error on the host: the kernel then reads a bad
    address on the card."""
    assert _c_signatures()[name] == _kernels._SIGNATURES[name]


def test_configs_accept_fused_ffn_and_keep_jax_refusals():
    """``fused_ffn=True`` constructs on both configs (it is ported); GPT's
    JAX ValueErrors for MoE and int8 weights come before any
    not-ported error."""
    assert GPTConfig(**TINY, fused_ffn=True).fused_ffn
    assert BertConfig(**BERT_TINY, fused_ffn=True).fused_ffn
    model = GPTModel(GPTConfig(**TINY, fused_ffn=True), device="cpu")
    assert model.layers[0].mlp.fused_ffn
    with pytest.raises(ValueError, match="n_experts > 0"):
        GPTConfig(**TINY, fused_ffn=True, n_experts=4)
    with pytest.raises(ValueError, match="weight_quant"):
        GPTConfig(**TINY, fused_ffn=True, weight_quant="int8")


_TP_CASES = [
    ("column", dict(gather_output=False)),
    ("column", dict(gather_output=True)),
    ("row", dict(input_is_parallel=True)),
    ("column", dict(init_method="const")),
    ("row", dict(init_method="const")),
    ("column", dict(stride=2)),
    ("column", dict(keep_master_weight_for_test=True)),
    ("column", dict(skip_bias_add=True)),
    ("row", dict(skip_bias_add=True)),
    ("column", dict(no_async_tensor_model_parallel_allreduce=True)),
    ("row", dict(gradient_accumulation_fusion=True)),
    ("column", dict(axis_name=None)),
    ("row", dict(seq_dim=1)),
    ("column", dict(overlap_chunks=0)),
    ("embedding", dict(init_method="const")),
    ("embedding", dict(axis_name=None)),
]


@pytest.mark.parametrize("kind,kw", _TP_CASES,
                         ids=[f"{k}-{list(kw)[0]}-{list(kw.values())[0]}"
                              for k, kw in _TP_CASES])
def test_tp_layers_take_the_reference_keywords_at_world_size_1(kind, kw):
    """Each keyword of the JAX tensor-parallel layers builds the port's
    layer (it raised ``TypeError``) and gives the JAX layer's output at
    world size 1 (the JAX layer called serially, ``axis_name=None``):
    ``skip_bias_add`` returns ``(x @ W.T, bias)`` unadded, ``init_method``
    fills the weight (apex's in-place form in the port)."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.tensor_parallel import layers as jL
    from apex_tpu_torch.transformer.tensor_parallel import layers as tL

    jkw, tkw = dict(kw), dict(kw)
    if kw.get("init_method") == "const":
        jkw["init_method"] = lambda key, shape, dtype: jnp.full(shape, 0.25,
                                                                dtype)
        tkw["init_method"] = lambda w: torch.nn.init.constant_(w, 0.25)
    jkw["axis_name"] = None
    rng = np.random.RandomState(3)
    if kind == "embedding":
        jl = jL.VocabParallelEmbedding(16, 8, **jkw)
        tl = tL.VocabParallelEmbedding(16, 8, device="cpu", **tkw)
        params = jl.init_params(jax.random.PRNGKey(0))
        tl.reset_parameters(torch.Generator().manual_seed(0))
        ids = rng.randint(0, 16, (2, 5))
        if kw.get("init_method"):
            np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                          np.asarray(params["weight"]))
        tl.weight.data.copy_(torch.from_numpy(np.array(params["weight"])))
        np.testing.assert_allclose(
            tl(torch.from_numpy(ids)).detach().numpy(),
            np.asarray(jl(params, jnp.asarray(ids))), rtol=1e-6)
        return
    jcls, tcls = ((jL.ColumnParallelLinear, tL.ColumnParallelLinear)
                  if kind == "column" else
                  (jL.RowParallelLinear, tL.RowParallelLinear))
    jl = jcls(8, 12, **jkw)
    tl = tcls(8, 12, device="cpu", **tkw)
    params = jl.init_params(jax.random.PRNGKey(0))
    tl.reset_parameters(torch.Generator().manual_seed(0))
    if kw.get("init_method"):
        np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                      np.asarray(params["weight"]))
    bias = rng.randn(12).astype(np.float32)
    params = dict(params, bias=jnp.asarray(bias))
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(params["weight"])))
        tl.bias.copy_(torch.from_numpy(bias))
    x = rng.randn(3, 8).astype(np.float32)
    jy, jb = jl(params, jnp.asarray(x))
    ty, tb = tl(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-6, atol=1e-6)
    if kw.get("skip_bias_add"):
        np.testing.assert_array_equal(tb.detach().numpy(), np.asarray(jb))
    else:
        assert tb is None and jb is None


def test_tp_layers_keep_the_reference_refusals():
    """apex's RuntimeErrors for keyword combinations, then the multi-GPU
    refusal of sequence parallelism."""
    from apex_tpu_torch.transformer.tensor_parallel import layers as tL
    with pytest.raises(RuntimeError, match="gather_output"):
        tL.ColumnParallelLinear(8, 8, sequence_parallel_enabled=True,
                                device="cpu")
    with pytest.raises(RuntimeError, match="input_is_parallel"):
        tL.RowParallelLinear(8, 8, sequence_parallel_enabled=True,
                             device="cpu")
    with pytest.raises(RuntimeError, match="overlap_chunks"):
        tL.RowParallelLinear(8, 8, overlap_chunks=2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tL.ColumnParallelLinear(8, 8, gather_output=False,
                                sequence_parallel_enabled=True, device="cpu")
