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
                                                flash_attention_decode_paged,
                                                flash_attention_dkv,
                                                flash_attention_dq, flash_fwd)
from apex_tpu_torch.ops.fused_ffn import ffn_bwd, ffn_dw, ffn_dx, ffn_fwd
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
from apex_tpu_torch.ops.lm_head import (lm_head_bwd, lm_head_dw, lm_head_dx,
                                        lm_head_fwd)
from apex_tpu_torch.ops.quant_gemm import quant_gemm
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
            multi_tensor_sgd, multi_tensor_adagrad, multi_tensor_novograd,
            flash_attention_decode_paged, quant_gemm)
BERT_TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_seq_len=32, fused_lm_head=False)


def _port_files():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*_torch.py")))


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


def test_data_parallel_entry_points_follow_their_tensors(monkeypatch):
    """``DistributedDataParallel`` and the ZeRO optimizers run where their
    parameters are: CPU parameters take the CPU (no process group: an axis
    of one rank); a module without parameters defaults to the card and
    raises without one."""
    from torch import nn
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         DistributedFusedAdam,
                                         DistributedFusedLAMB)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedDataParallel(nn.ReLU())
    net = nn.Linear(3, 2)
    ddp = DistributedDataParallel(net)
    ddp(torch.ones(4, 3)).sum().backward()
    assert ddp.world_size == 1 and net.weight.grad.shape == (2, 3)
    for cls in (DistributedFusedAdam, DistributedFusedLAMB):
        bare = nn.Linear(3, 2)      # its reduce-scatter is the reduction
        bare(torch.ones(4, 3)).sum().backward()
        opt = cls(bare.parameters(), lr=1e-2, block_rows=8)
        opt.step()
        assert opt.world_size == 1 and opt.state_dict()["rank"] == 0


def test_cpu_two_rank_data_parallel_launches_no_kernel(tmp_path):
    """Two gloo ranks on the CPU run DDP, the ZeRO optimizers, SyncBN
    across the ranks and LARC over tiny BERT (O2), GPT and resnet26 on the
    plain versions: no counter moves on either rank."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_dist import run
    out = run(tmp_path, 2, "cpu_launches", {})
    for rank in out:
        assert rank["launches"] and not any(rank["launches"].values()), \
            rank["launches"]
        assert np.all(np.isfinite(rank["losses"]))


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


def test_cpu_paged_and_int8_serving_launch_no_kernel():
    """The paged engine (monolithic and chunked prefill, the int8 pool)
    and an int8-weight model on the CPU take every plain version."""
    from apex_tpu_torch.serving import PagedInferenceEngine
    for c in COUNTERS:
        c.launches = 0
    for cfg_kw, kw in ((dict(), dict()), (dict(),
                                          dict(chunked_prefill=True)),
                       (dict(), dict(chunked_prefill=True, kv_quant="int8")),
                       (dict(weight_quant="int8"), dict())):
        model = GPTModel(GPTConfig(**TINY, **cfg_kw), device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        engine = PagedInferenceEngine(model, max_slots=2, block_size=4,
                                      device="cpu", **kw)
        for i, n in enumerate((3, 9, 5)):
            engine.submit(Request(request_id=i, prompt=list(range(1, n + 1)),
                                  max_new_tokens=3))
        assert sorted(r.finish_reason for r in engine.run()) == \
            ["length"] * 3
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_serving_imports_without_a_card_and_defaults_to_it(monkeypatch):
    """``apex_tpu_torch.serving`` imports on a machine with no card; its
    engine and pools, like the other entry points, default to CUDA and
    raise without it."""
    import importlib
    serving = importlib.import_module("apex_tpu_torch.serving")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPTModel(GPTConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.PagedInferenceEngine(model, block_size=4)
    for pool in (serving.PagedKVCache, serving.QuantizedPagedKVCache):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pool(4, 4, 1, 1, 8)


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
                                    "lm_head_dw", "lm_head_bwd", "ffn_fwd",
                                    "ffn_dx",
                                    "ffn_dw", "ffn_bwd", "multi_tensor_axpby_",
                                    "multi_tensor_sgd", "multi_tensor_adagrad",
                                    "multi_tensor_novograd",
                                    "flash_attention_decode",
                                    "flash_attention_decode_paged",
                                    "quant_gemm"])
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
        "lm_head_bwd": lambda: lm_head_bwd(x, x, rows, rows.float(),
                                           rows.float()),
        "ffn_fwd": lambda: ffn_fwd(x, x.t(), rows.float()[:4], x),
        "ffn_dx": lambda: ffn_dx(x, x, x.t(), x),
        "ffn_dw": lambda: ffn_dw(x, x, x, x.t(), x),
        "ffn_bwd": lambda: ffn_bwd(x, x, x, x.t(), x),
        "multi_tensor_axpby_": lambda: multi_tensor_axpby_([x], [x], [x],
                                                           1.0, 2.0),
        "multi_tensor_sgd": lambda: multi_tensor_sgd(
            [x], [x], [x], None, torch.empty(5, device="meta")),
        "multi_tensor_adagrad": lambda: multi_tensor_adagrad(
            [x], [x], [x], None, torch.empty(4, device="meta")),
        "multi_tensor_novograd": lambda: multi_tensor_novograd(
            [x], [x], [x], None, torch.empty(1, device="meta"),
            torch.empty(6, device="meta")),
        "flash_attention_decode": lambda: flash_attention_decode(
            torch.empty((2, 8, 16), device="meta"), meta, meta,
            torch.ones(2, dtype=torch.int32, device="meta")),
        "flash_attention_decode_paged": lambda: flash_attention_decode_paged(
            torch.empty((2, 4, 16), device="meta"), meta, meta,
            torch.zeros((2, 3), dtype=torch.int32, device="meta"),
            torch.ones(2, dtype=torch.int32, device="meta")),
        "quant_gemm": lambda: quant_gemm(
            x, torch.empty((6, 8), dtype=torch.int8, device="meta"),
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


def _decode_operands(dtype, hd, slots=2, heads=4, seq=32, layers=2):
    """The decode kernels' operands as the model passes them, on the meta
    device (no memory, no card): q split from the ``(b, 1, nh, 3*hd)`` qkv
    projection, a ring's per-layer K view and a pool's."""
    q = torch.empty((slots, 1, heads, 3 * hd), dtype=dtype,
                    device="meta").split(hd, dim=-1)[0][:, 0]
    ring = torch.empty((slots, layers, 2, seq, heads, hd), dtype=dtype,
                       device="meta")
    pool = torch.empty((9, layers, 2, 16, heads, hd), dtype=dtype,
                       device="meta")
    return dict(q=q, k_cache=ring[:, 1, 0], k_pool=pool[:, 1, 0])


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_alignment_check_raises_before_any_launch(monkeypatch, dtype,
                                                         hd):
    """The decode kernels read 16 bytes a lane: the model's layouts pass
    the wrappers' check, and an operand whose strides or base are off 16
    bytes is refused, with nothing launched."""
    from apex_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(_kernels, "lib",
                        lambda: pytest.fail("a kernel was launched"))
    ops = _decode_operands(dtype, hd)
    fa._check_decode_aligned("flash_attention_decode", **ops)
    # a projection one element wider: q's slot and head strides are off
    wide = torch.empty((2, 1, 4, 3 * hd + 1), dtype=dtype,
                       device="meta").split(hd, dim=-1)[0][:, 0]
    with pytest.raises(ValueError, match=r"^flash_attention_decode: q's "
                                         r"strides must be multiples of 16"):
        fa._check_decode_aligned("flash_attention_decode", q=wide,
                                 k_cache=ops["k_cache"])
    # a cache one element off its 16-byte boundary (CPU memory: a real base)
    cache = torch.zeros((2, 8, 4, hd + 1), dtype=dtype)[..., 1:]
    with pytest.raises(ValueError, match=r"^flash_attention_decode_paged: "
                                         r"k_pool must start on a 16-byte"):
        fa._check_decode_aligned("flash_attention_decode_paged",
                                 q=ops["q"], k_pool=cache)


def test_decode_split_is_the_kernels_and_fits_the_pool_block_sizes():
    """The wrappers size the split pass's workspace with ``DECODE_SPLIT``,
    which the C entry points check against ``kDecodeSplit``; it is a
    multiple of the paged engine's block sizes (8, the default, and 16)."""
    import re
    from apex_tpu_torch.ops.flash_attention import DECODE_SPLIT
    src = (_kernels.CSRC / "decode.cuh").read_text()
    assert int(re.search(r"kDecodeSplit = (\d+);", src).group(1)) \
        == DECODE_SPLIT
    assert DECODE_SPLIT % 8 == 0 and DECODE_SPLIT % 16 == 0


def test_configs_accept_fused_ffn_and_keep_jax_refusals():
    """``fused_ffn=True`` constructs on both configs (it is ported), and so
    do the expert, context and plan knobs (ported since the pipeline /
    context / expert slice: none raises ``NotImplementedError`` any more);
    GPT's JAX ValueErrors for MoE with the fused FFN, int8 weights or
    sequence parallelism, and for context parallelism with sequence
    parallelism or attention dropout, stay."""
    from apex_tpu_torch.parallel import ParallelPlan
    assert GPTConfig(**TINY, fused_ffn=True).fused_ffn
    assert BertConfig(**BERT_TINY, fused_ffn=True).fused_ffn
    model = GPTModel(GPTConfig(**TINY, fused_ffn=True), device="cpu")
    assert model.layers[0].mlp.fused_ffn
    moe = GPTConfig(**TINY, n_experts=4, moe_top_k=2,
                    moe_capacity_factor=2.0, moe_aux_weight=0.1,
                    expert_axis="expert", expert_parallel_size=2)
    assert (moe.n_experts, moe.moe_top_k, moe.expert_parallel_size) \
        == (4, 2, 2)
    assert GPTConfig(**TINY, context_axis="context",
                     context_mechanism="ulysses").context_mechanism \
        == "ulysses"
    plan = ParallelPlan(remat=True)
    assert GPTConfig(**TINY, plan=plan).remat
    assert BertConfig(**BERT_TINY, plan=plan).remat
    with pytest.raises(ValueError, match="n_experts > 0"):
        GPTConfig(**TINY, fused_ffn=True, n_experts=4)
    with pytest.raises(ValueError, match="weight_quant"):
        GPTConfig(**TINY, fused_ffn=True, weight_quant="int8")
    with pytest.raises(ValueError, match="3D weight layout"):
        GPTConfig(**TINY, n_experts=4, weight_quant="int8")
    with pytest.raises(ValueError, match="does not compose with MoE"):
        GPTConfig(**TINY, n_experts=4, tensor_parallel_size=2,
                  axis_name="model", sequence_parallel=True)
    with pytest.raises(ValueError, match="both shard the"):
        GPTConfig(**TINY, context_axis="context", tensor_parallel_size=2,
                  axis_name="model", sequence_parallel=True)
    with pytest.raises(ValueError, match="attention_dropout is not"):
        GPTConfig(**TINY, context_axis="context", attention_dropout=0.1)
    with pytest.raises(ValueError, match="expert_axis requires|requires "
                       "n_experts"):
        GPTConfig(**TINY, expert_axis="expert")


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
    """apex's RuntimeErrors for keyword combinations; sequence parallelism
    builds since the tensor-parallel slice, and a layer whose group lacks
    its ``world_size`` ranks refuses to run."""
    from apex_tpu_torch.transformer.tensor_parallel import layers as tL
    with pytest.raises(RuntimeError, match="gather_output"):
        tL.ColumnParallelLinear(8, 8, sequence_parallel_enabled=True,
                                device="cpu")
    with pytest.raises(RuntimeError, match="input_is_parallel"):
        tL.RowParallelLinear(8, 8, sequence_parallel_enabled=True,
                             device="cpu")
    with pytest.raises(RuntimeError, match="overlap_chunks"):
        tL.RowParallelLinear(8, 8, overlap_chunks=2, device="cpu")
    layer = tL.ColumnParallelLinear(8, 8, gather_output=False,
                                    sequence_parallel_enabled=True,
                                    device="cpu")
    assert layer(torch.zeros(2, 3, 8))[0].shape == (2, 3, 8)
    layer = tL.RowParallelLinear(8, 8, world_size=2, device="cpu")
    assert tuple(layer.weight.shape) == (8, 4)
    with pytest.raises(ValueError, match="world_size=2"):
        layer(torch.zeros(2, 8))


def test_fleet_parts_of_the_paged_engine_no_longer_raise():
    """``prefill_only``, ``export_kv`` and ``adopt_kv`` (which raised
    ``NotImplementedError`` until the fleet slice) run on the CPU: a
    parked request's KV moves between two engines and decodes there."""
    import apex_tpu_torch.serving.engine as paged
    from apex_tpu_torch.inference import Request
    from apex_tpu_torch.serving import PagedInferenceEngine
    assert not hasattr(paged, "FLEET_SLICE")
    model = GPTModel(GPTConfig(**TINY), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    pf = PagedInferenceEngine(model, device="cpu", block_size=4,
                              chunked_prefill=True, prefill_only=True)
    dc = PagedInferenceEngine(model, device="cpu", block_size=4)
    pf.submit(Request(0, [1, 2, 3, 4, 5], max_new_tokens=3))
    while not pf.handoffs_ready():
        pf.step()
    handoff = pf.export_kv(0)
    assert handoff.nbytes() == 2 * dc.pool.block_bytes
    dc.adopt_kv(handoff)
    (resp,) = dc.run()
    assert resp.finish_reason == "length" and len(resp.tokens) == 3


def test_serving_exports_every_name_of_the_reference():
    import apex_tpu.serving as reference
    import apex_tpu_torch.serving as port
    missing = [n for n in reference.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert sorted(port.__all__) == sorted(reference.__all__)


def _conformer_args():
    from apex_tpu_torch.examples.conformer import train_rnnt
    return train_rnnt.parse_args(["--layers", "1", "--hidden", "32",
                                  "--heads", "2", "--vocab", "16",
                                  "--pred-hidden", "32", "--n-mels", "8"])


def test_rnn_contrib_and_conformer_entry_points_raise_without_cuda(
        monkeypatch):
    """The modules of the RNN, contrib and conformer slice default to the
    card and raise without one unless ``device="cpu"`` is asked for."""
    import warnings
    from apex_tpu_torch import RNN
    from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    from apex_tpu_torch.examples.conformer import train_rnnt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [lambda d=None: SelfMultiheadAttn(32, 2, device=d),
              lambda d=None: EncdecMultiheadAttn(32, 2, device=d),
              lambda d=None: FastLayerNorm(8, device=d),
              lambda d=None: GroupNorm(2, 8, device=d),
              lambda d=None: BatchNorm2d_NHWC(8, device=d),
              lambda d=None: GroupBatchNorm2d(8, device=d),
              lambda d=None: train_rnnt.ConformerRNNT(_conformer_args(), d)]
    makers += [lambda d=None, f=f: getattr(RNN, f)(2, 2, device=d)
               for f in RNN.__all__]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for make in makers:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
            make("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rnnt.main(["--steps", "1"])


def test_cpu_contrib_ops_launch_no_kernel():
    """The contrib ops over the kernels (MHA, fmha, attention_core, the
    LayerNorms, FusedAdamSWA) and a conformer step take every wrapper's
    plain version on CPU tensors: no counter moves."""
    from apex_tpu_torch.contrib.fmha import fmha
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    from apex_tpu_torch.contrib.openfold_triton import (
        FusedAdamSWA, LayerNormSmallShapeOptImpl, attention_core)
    from apex_tpu_torch.examples.conformer import train_rnnt
    for c in COUNTERS:
        c.launches = 0
    gen = torch.Generator().manual_seed(0)
    mha = SelfMultiheadAttn(32, 2, include_norm_add=True, dropout=0.1,
                            device="cpu").init_params(gen)
    x = torch.randn(8, 2, 32, generator=gen)
    mha(x, dropout_seed=3).sum().backward()
    qkv = torch.randn(12, 3, 2, 16, generator=gen, requires_grad=True)
    fmha(qkv, torch.tensor([0, 5, 12]), 8, causal=True).sum().backward()
    q = torch.randn(2, 2, 8, 16, generator=gen, requires_grad=True)
    attention_core(q, q, q).sum().backward()
    ln = FastLayerNorm(32, device="cpu")
    LayerNormSmallShapeOptImpl.apply(ln(x), ln.weight, ln.bias).sum() \
        .backward()
    opt = FusedAdamSWA(mha.parameters(), lr=1e-3)
    opt.step()
    trainer = train_rnnt.build(_conformer_args(), torch.device("cpu"))
    batch = train_rnnt.batches(_conformer_args(), "cpu")()
    assert torch.isfinite(trainer.step(*batch))
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)
