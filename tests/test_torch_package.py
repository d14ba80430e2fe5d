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
from apex_tpu_torch.ops.multi_tensor import (multi_tensor_adam,
                                             multi_tensor_lamb_stage1,
                                             multi_tensor_lamb_stage2,
                                             multi_tensor_scale_,
                                             multi_tensor_sumsq)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
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
            lm_head_dx, lm_head_dw, ffn_fwd, ffn_dx, ffn_dw)
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
                                    "ffn_dw"])
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
