"""Run port code on N ``gloo`` ranks on the CPU, for the ``test_torch_*``
data-parallel tests (pytest does not collect this file).

:func:`run` starts one Python process per rank running this file, each
initialising :mod:`torch.distributed` through a ``file://`` store in its
own directory (no TCP port, so concurrent test workers never collide),
runs ``CASES[case](rank, world, inputs)`` on the pickled numpy inputs and
pickles what it returns.  A spawn that has not finished within
``timeout`` seconds is killed and fails the test, so a hung collective
costs one spawn's timeout, not the suite's.  The ranks import torch and
``apex_tpu_torch`` only.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(tmp_path, world, case, inputs, timeout=120):
    """Run ``case`` on ``world`` ranks; returns the per-rank results."""
    return start(tmp_path, world, case, inputs, timeout).result()


class start:
    """Start ``case`` on ``world`` ranks and return at once (the caller may
    work meanwhile); :meth:`result` waits for the ranks, within
    ``timeout`` seconds of the start, and returns their results."""

    def __init__(self, tmp_path, world, case, inputs, timeout=120):
        self.world, self.case = world, case
        self.d, self.procs = _spawn(tmp_path, world, case, inputs)
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def result(self):
        return _finish(self.d, self.procs, self.world, self.case,
                       self.deadline, self.timeout)


def _spawn(tmp_path, world, case, inputs):
    d = pathlib.Path(tmp_path) / f"{case}_w{world}"
    d.mkdir(parents=True)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(world):
        log = open(d / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(d), case, str(r), str(world)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return d, procs


def _finish(d, procs, world, case, deadline, timeout):
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{case} on {world} ranks did not finish in {timeout} s:"
                    f"\n{_logs(d, world)}")
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(p.returncode for p, _ in procs):
        raise AssertionError(f"{case} failed on a rank:\n{_logs(d, world)}")
    out = []
    for r in range(world):
        with open(d / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _logs(d, world):
    return "\n".join(f"--- rank {r}\n"
                     + (d / f"log{r}.txt").read_text()[-4000:]
                     for r in range(world))


# ---------------------------------------------------------------------------
# the cases (run inside a rank)
# ---------------------------------------------------------------------------

def _np(t):
    """A tensor as numpy (bf16 as f32, exactly)."""
    import torch
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def case_collectives(rank, world, inp):
    """The compressed collectives and the rank layout."""
    import torch
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils import compressed_allreduce as CA
    out = {}
    x = torch.from_numpy(inp["x"][rank])
    for mode in (None, "bf16", "int8"):
        out[f"rs_{mode}"] = _np(CA.reduce_scatter(x, world_size=world,
                                                  mode=mode))
        shard = CA.reduce_scatter(x, mode=mode)
        out[f"ag_{mode}"] = _np(CA.all_gather_rows(shard, mode=mode))
        for name, t in inp["leaves"].items():
            out[f"psum_{name}_{mode}"] = _np(CA.psum_compressed(
                torch.from_numpy(t[rank]), mode=mode))
    tree = {"f": torch.from_numpy(inp["leaves"]["odd"][rank]),
            "i": torch.full((3,), rank + 1, dtype=torch.int32)}
    got = CA.psum_tree_compressed(tree, mode="int8")
    out["tree_f"], out["tree_i"] = _np(got["f"]), _np(got["i"])
    try:
        CA.reduce_scatter(x[:world * 3 + 1], mode=None)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    for tp, pp in inp["layouts"]:
        layout = ps.initialize_model_parallel(tp, pp)
        out[f"layout_{tp}_{pp}"] = layout.copy()
        out[f"groups_{tp}_{pp}"] = {
            axis: torch.distributed.get_process_group_ranks(
                ps.get_group(axis)) for axis in ps.AXES}
        out[f"ranks_{tp}_{pp}"] = (ps.get_data_parallel_rank(),
                                   ps.get_pipeline_model_parallel_rank(),
                                   ps.get_tensor_model_parallel_rank())
        ps.destroy_model_parallel()
    return out


def _mlp(seed_params, dtype=None):
    import torch
    from torch import nn
    model = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    with torch.no_grad():
        for p, v in zip(model.parameters(), seed_params):
            p.copy_(torch.from_numpy(v))
    return model


def case_ddp(rank, world, inp):
    """DDP's reduce in every mode, Reducer, allreduce_gradients,
    accumulate, and the module wrapper training an MLP."""
    import torch
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         allreduce_gradients)
    out = {}
    grads = {k: torch.from_numpy(v[rank]) for k, v in inp["grads"].items()}
    for k in inp["bf16"]:
        grads[k] = grads[k].to(torch.bfloat16)
    for name, kw in inp["modes"].items():
        ddp = DistributedDataParallel(torch.nn.Linear(2, 2), **kw)
        out[f"reduce_{name}"] = {k: _np(v)
                                 for k, v in ddp.reduce(grads).items()}
    grads = {k: v.float() for k, v in grads.items()}
    out["allreduce_avg"] = {k: _np(v) for k, v in
                            allreduce_gradients(grads).items()}
    out["allreduce_sum"] = {k: _np(v) for k, v in
                            allreduce_gradients(grads, average=False).items()}
    red = Reducer()
    out["reducer_tree"] = {k: _np(v) for k, v in red.reduce(grads).items()}
    model = _mlp(inp["mlp"])
    for p, g in zip(model.parameters(), inp["mlp_grads"]):
        p.grad = torch.from_numpy(g[rank]).clone()
    Reducer(model).reduce()
    out["reducer_module"] = [_np(p.grad) for p in model.parameters()]
    acc = DistributedDataParallel.accumulate(None, grads)
    acc = DistributedDataParallel.accumulate(acc, grads, torch.float64)
    out["accumulate"] = {k: v.numpy().copy() for k, v in acc.items()}
    assert all(v.dtype == torch.float64 for v in acc.values())
    # the module wrapper: lr 0.1 SGD steps on this rank's rows
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    for name, c in inp["train"].items():
        # rank 0's parameters reach every rank through the broadcast
        model = _mlp(inp["mlp"] if rank == 0 else inp["mlp_other"])
        ddp = DistributedDataParallel(model, **c["kw"])
        xs, ys = ddp.scatter((x, y))
        for _ in range(2):
            for p in ddp.parameters():
                p.grad = None
            if c["no_sync"]:
                k = xs.shape[0] // 2
                with ddp.no_sync():
                    (0.5 * torch.mean((ddp(xs[:k]) - ys[:k]) ** 2)
                     ).backward()
                (0.5 * torch.mean((ddp(xs[k:]) - ys[k:]) ** 2)).backward()
            else:
                torch.mean((ddp(xs) - ys) ** 2).backward()
            with torch.no_grad():
                for p in ddp.parameters():
                    p.sub_(0.1 * p.grad)
        out[f"train_{name}"] = [_np(p) for p in ddp.parameters()]
    return out


def case_syncbn(rank, world, inp):
    """SyncBatchNorm across the ranks: output, running statistics and the
    gradients of sum(y * dy) (the parameters' summed over the ranks)."""
    import torch
    from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm
    from apex_tpu_torch.parallel.sync_batchnorm import BatchNormState
    from apex_tpu_torch.utils.collectives import all_reduce_
    out = {}
    x = torch.from_numpy(inp["x"][rank]).requires_grad_()
    dy = torch.from_numpy(inp["dy"][rank])
    bn = SyncBatchNorm(x.shape[1], momentum=0.1, process_group="data")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    y = bn(x)
    (y * dy).sum().backward()
    group = torch.distributed.group.WORLD
    out["y"] = _np(y)
    out["dx"] = _np(x.grad)
    out["dw"] = _np(all_reduce_(bn.weight.grad.clone(), group))
    out["db"] = _np(all_reduce_(bn.bias.grad.clone(), group))
    out["running"] = (_np(bn.running_mean), _np(bn.running_var),
                      int(bn.num_batches_tracked))
    state = BatchNormState(torch.zeros(x.shape[1]), torch.ones(x.shape[1]),
                           torch.zeros((), dtype=torch.int32))
    yf, st = sync_batch_norm(x.detach(), torch.from_numpy(inp["w"]),
                             torch.from_numpy(inp["b"]), state,
                             training=True, axis_name="data")
    out["functional"] = (_np(yf), _np(st.running_mean), _np(st.running_var))
    bn.eval()
    out["eval"] = _np(bn(x.detach()))
    return out


def case_zero(rank, world, inp):
    """DistributedFusedAdam / DistributedFusedLAMB steps from the same
    parameters on each rank's gradients; with ``plain``, the port's
    unsharded optimizer on the mean gradient beside it; the refusal of a
    DDP module's parameters; an overflow on one rank under amp."""
    import torch
    from torch import nn
    from apex_tpu_torch import convert
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         DistributedFusedAdam,
                                         DistributedFusedLAMB)
    out = {}
    for name, c in inp["runs"].items():
        dtype = getattr(torch, c.get("dtype", "float32"))
        cls = (DistributedFusedLAMB if c["opt"] == "lamb"
               else DistributedFusedAdam)
        params = [nn.Parameter(torch.tensor(v, dtype=dtype))
                  for v in inp["params"]]
        opt = cls(params, **c["kw"])
        if "carry" in c:
            opt.load_state_dict(convert.distributed_state_from_jax(
                opt, c["carry"]["state"]))
            with torch.no_grad():
                for p, v in zip(params, c["carry"]["params"]):
                    p.copy_(torch.from_numpy(v))
        for s in c["steps"]:
            for p, g in zip(params, inp["grads"]):
                p.grad = torch.tensor(g[s][rank], dtype=dtype)
            opt.step(**c["step_kw"][s])
        sd = opt.state_dict()
        res = {"params": [_np(p) for p in params],
               "state": {k: {n: _np(t) for n, t in st.items()}
                         for k, st in sd["buckets"].items()},
               "step": int(sd["step"]),
               "master_params": [_np(t) for t in opt.master_params()]}
        if c.get("plain"):
            ref = [nn.Parameter(torch.tensor(v, dtype=dtype))
                   for v in inp["params"]]
            pcls = FusedLAMB if c["opt"] == "lamb" else FusedAdam
            kw = {k: v for k, v in c["kw"].items()
                  if k not in ("block_rows", "message_size",
                               "allreduce_dtype")}
            popt = pcls(ref, **kw)
            for s in c["steps"]:
                for p, g in zip(ref, inp["grads"]):
                    p.grad = torch.tensor(g[s].mean(0), dtype=dtype)
                popt.step(**c["step_kw"][s])
            res["plain"] = [_np(p) for p in ref]
        out[name] = res
    # the pairing with DDP raises, over the module's parameters or the
    # wrapped model's (DDP's hooks are on them either way)
    model = _mlp(inp["mlp"])
    ddp = DistributedDataParallel(model)
    out["refused"] = []
    for params in (ddp.parameters(), list(model.parameters())[:2]):
        try:
            DistributedFusedAdam(params)
            out["refused"].append("no error")
        except ValueError as e:
            out["refused"].append(str(e))
    out["overflow"] = _zero_overflow(rank, world, inp)
    return out


def _zero_overflow(rank, world, inp):
    """fp16 O2 under a dynamic loss scaler, DistributedFusedAdam stepping;
    the last rank's first gradient holds an inf.  Per step: the
    parameters, the loss scale and the step count."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.parallel import DistributedFusedAdam
    model = _mlp(inp["mlp"])
    opt = DistributedFusedAdam(model.parameters(), lr=1e-2, block_rows=8)
    state = amp.initialize(model, opt, opt_level="O2",
                           half_dtype=torch.float16, device="cpu")
    assert state.scaler.dynamic
    state.scaler.loss_scale.fill_(256.0)
    k = inp["x"].shape[0] // world
    xs = torch.from_numpy(inp["x"][rank * k:(rank + 1) * k]).half()
    ys = torch.from_numpy(inp["y"][rank * k:(rank + 1) * k])
    out = {"start": [_np(p) for p in model.parameters()], "params": [],
           "scale": [], "step": []}
    for s in range(2):
        opt.zero_grad()
        loss = torch.mean((model(xs).float() - ys) ** 2)
        amp.scale_loss(loss, state.scaler).backward()
        if s == 0 and rank == world - 1:
            with torch.no_grad():
                next(model.parameters()).grad[0, 0] = float("inf")
        amp.unscale_step(opt, state.scaler)
        out["params"].append([_np(p) for p in model.parameters()])
        out["scale"].append(float(state.scaler.loss_scale))
        out["step"].append(int(opt._step_count))
    return out


def _counters():
    import importlib
    out = []
    for name in ("flash_attention", "fused_ffn", "layer_norm", "lm_head",
                 "multi_tensor", "quant_gemm"):
        mod = importlib.import_module(f"apex_tpu_torch.ops.{name}")
        out += [f for f in vars(mod).values()
                if callable(f) and hasattr(f, "launches")]
    return out


def case_cpu_launches(rank, world, inp):
    """A CPU data-parallel step of every ported kind — a tiny BERT O2
    with DistributedFusedLAMB (int8 transport), a tiny GPT with
    DistributedFusedAdam, a resnet26 with SyncBN across the ranks under
    DDP and LARC(FusedSGD) — takes the plain versions: no counter
    moves."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet26
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import (LARC, DistributedDataParallel,
                                         DistributedFusedAdam,
                                         DistributedFusedLAMB,
                                         convert_syncbn_model)
    from apex_tpu_torch.transformer import parallel_state as ps
    counters = _counters()
    for c in counters:
        c.launches = 0
    ps.initialize_model_parallel()
    gen = torch.Generator().manual_seed(0)
    tiny = dict(vocab_size=64, hidden_size=64, num_layers=2,
                num_attention_heads=4, max_seq_len=32)
    tokens = torch.randint(0, 64, (2 * world, 16), generator=gen)
    bert = BertModel(BertConfig(**tiny, dtype=torch.bfloat16),
                     device="cpu").init_params(gen)
    opt = DistributedFusedLAMB(bert.parameters(), lr=1e-3,
                               allreduce_dtype="int8", block_rows=8)
    amp.initialize(bert, opt, opt_level="O2")
    x = tokens[2 * rank:2 * (rank + 1)]
    losses = [float(bert.loss(x, torch.where(x % 3 == 0, x, -1)).detach())]
    bert.loss(x, torch.where(x % 3 == 0, x, -1)).backward()
    opt.step()
    gpt = GPTModel(GPTConfig(**tiny), device="cpu").init_params(gen)
    opt = DistributedFusedAdam(gpt.parameters(), lr=1e-3, block_rows=8)
    loss = gpt.loss(x, x)
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
    net = convert_syncbn_model(resnet26(device="cpu", width=8,
                                        num_classes=10).init_params(gen),
                               process_group=ps.get_data_parallel_group())
    ddp = DistributedDataParallel(net)
    opt = LARC(FusedSGD(ddp.parameters(), lr=0.1, momentum=0.9,
                        weight_decay=1e-4))
    images = torch.randn(2 * world, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (2 * world,), generator=gen)
    xs, ys = ddp.scatter((images, labels))
    loss = net.loss(xs, ys)
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
    ps.destroy_model_parallel()
    return {"launches": {c.__name__: c.launches for c in counters},
            "losses": losses}


def case_examples(rank, world, inp):
    """The ImageNet example's distributed path (``--sync-bn``, DDP,
    FusedSGD) on this rank's shard of the global batch, and the simple
    DDP example."""
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.examples.simple.distributed import (
        distributed_data_parallel as simple)
    res = main_amp.main(inp["argv"])
    params = [_np(p) for p in res["trainer"].model.parameters()]
    out = {"losses": [res["warmup_loss"]] + res["losses"],
           "devices": res["devices"], "params": params}
    s = simple.main(["--device", "cpu", "--steps", "3"])
    out["simple"] = (s["losses"], s["devices"])
    return out


def _tp_mappings(rank, inp):
    """The seven mappings and both rings on this rank's input: outputs and
    the input gradients of sum(y * c)."""
    import torch
    from apex_tpu_torch.transformer.tensor_parallel import mappings as M
    out = {}
    for name, c in inp.items():
        x = torch.tensor(c["x"][rank]).requires_grad_()
        args = [x]
        if "w" in c:
            args.append(torch.tensor(c["w"][rank]).requires_grad_())
        y = getattr(M, c["fn"])(*args, **c["kw"])
        (y * torch.tensor(c["c"][rank])).sum().backward()
        out[name] = (_np(y), [_np(a.grad) for a in args])
    return out


def _tp_step(rank, world, inp, c):
    """One step of a tensor-parallel GPT (or BERT) from the JAX init's
    shards: ``forward_backward_no_pipelining`` over the model's loss, then
    FusedAdam.  Returns the loss, every gradient and the parameters after
    the step."""
    import torch
    from apex_tpu_torch import convert
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    bert = c.get("bert", False)
    cfg = (BertConfig if bert else GPTConfig)(
        **inp["tiny"], **c["kw"], dtype=getattr(torch, c["dtype"]),
        tensor_parallel_size=world, axis_name="model")
    model = (BertModel if bert else GPTModel)(cfg, device="cpu")
    params = inp["bert_params"] if bert else inp["params"]
    model.load_state_dict((convert.bert_params_from_jax if bert else
                           convert.gpt_params_from_jax)(params, cfg, rank))
    opt = FusedAdam(model.parameters(), lr=inp["lr"])
    seed = c.get("seed")
    tokens = torch.from_numpy(inp["tokens"])[None]
    targets = torch.from_numpy(inp["labels" if bert else "targets"])[None]
    nsp = (dict(nsp_labels=torch.from_numpy(inp["nsp_labels"]))
           if c.get("nsp") else {})
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: x,
        (lambda x, t: model.loss(x, t, **nsp)) if bert else
        (lambda x, t: model.loss(x, t, seed)), model, tokens, targets)
    # without NSP labels the NSP head has no gradient (JAX's is 0)
    grads = {n: _np(torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    opt.step()
    return dict(loss=float(loss), grads=grads,
                params={n: _np(p) for n, p in model.named_parameters()})


def _tp_masks(rank, world, inp):
    """The attention context of one layer on every rank, each rank holding
    the same local shard and input, with and without dropout: the ranks'
    masks must differ."""
    import torch
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    c = inp["masks"]
    cfg = GPTConfig(**c["tiny"], attention_dropout=0.5,
                    tensor_parallel_size=world, axis_name="model")
    attn = GPTModel(cfg, device="cpu").layers[0].attention
    with torch.no_grad():
        for name, v in c["shard"].items():
            attn.get_parameter(name).copy_(torch.from_numpy(v))
    seen = []
    attn.proj.register_forward_pre_hook(
        lambda mod, args: seen.append(_np(args[0])))
    x = torch.from_numpy(c["x"])
    with torch.no_grad():
        attn(x, dropout_seed=9)
        attn(x)
    return seen


def _tp_int8(rank, world, inp):
    """Vocab-parallel prefill logits of an int8 GPT at this rank, its
    weights quantized then sharded, and sharded then quantized."""
    import torch
    from apex_tpu_torch import convert
    from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                           quantize_decode_params,
                                           shard_params_for_tp)
    serial = convert.gpt_params_from_jax(inp["params"],
                                         GPTConfig(**inp["tiny"]))
    cfg = GPTConfig(**inp["tiny"], weight_quant="int8",
                    tensor_parallel_size=world, axis_name="model")
    out = {}
    for key, sd in (
            ("quantize_then_shard", shard_params_for_tp(
                cfg, quantize_decode_params(serial), rank)),
            ("shard_then_quantize", quantize_decode_params(
                shard_params_for_tp(cfg, serial, rank)))):
        model = GPTModel(cfg, device="cpu").load_quantized_(sd)
        logits, kv = model.prefill(torch.from_numpy(inp["tokens"]))
        out[key] = (_np(logits), _np(kv))
    return out


def _tp_surface(rank, world, inp):
    """The column layer with ``gather_output`` into the row layer with
    ``input_is_parallel=False`` (shards of one serial pair: output and
    the gradients of sum(y * c)); ``broadcast_data`` from rank 0; this
    rank's ``model_parallel_rng_key`` seed."""
    import torch
    from apex_tpu_torch.transformer import tensor_parallel as tp
    c = inp["surface"]
    col = tp.ColumnParallelLinear(8, 12, gather_output=True,
                                  world_size=world, device="cpu")
    row = tp.RowParallelLinear(12, 8, input_is_parallel=False,
                               world_size=world, device="cpu")
    gen = torch.Generator().manual_seed(3)
    col.reset_parameters(gen)
    row.reset_parameters(gen)
    with torch.no_grad():
        col.bias.copy_(torch.from_numpy(c["b1"]).chunk(world)[rank])
        row.bias.copy_(torch.from_numpy(c["b2"]))
    x = torch.tensor(c["x"]).requires_grad_()
    y, _ = row(col(x)[0])
    (y * torch.from_numpy(c["c"])).sum().backward()
    data = tp.broadcast_data(["tokens", "mask"], {
        k: torch.from_numpy(v) for k, v in c["data"].items()}
        if rank == 0 else None, torch.int64)
    return dict(y=_np(y), dx=_np(x.grad),
                col=(_np(col.weight), _np(col.weight.grad),
                     _np(col.bias.grad)),
                row=(_np(row.weight), _np(row.weight.grad),
                     _np(row.bias.grad)),
                data={k: v.numpy().copy() for k, v in data.items()},
                rng_seed=tp.model_parallel_rng_key(5).initial_seed())


def case_tp(rank, world, inp):
    """Tensor and sequence parallelism over the ``model`` group of all the
    ranks: the mappings and rings, GPT (and BERT) training steps in each
    configuration, and at two ranks the dropout streams and the int8
    linears."""
    from apex_tpu_torch.transformer import parallel_state as ps
    ps.initialize_model_parallel(world)
    out = {"mappings": _tp_mappings(rank, inp["mappings"]),
           "surface": _tp_surface(rank, world, inp),
           "steps": {name: _tp_step(rank, world, inp, c)
                     for name, c in inp["steps"].items()}}
    if "masks" in inp:
        out["masks"] = _tp_masks(rank, world, inp)
    if "int8" in inp:
        out["int8"] = _tp_int8(rank, world, inp)
    ps.destroy_model_parallel()
    return out


def case_mp(rank, world, inp):
    """Expert, context and pipeline parallelism: the functions of
    ``tests/_torch_mp_ranks.py`` that ``inp["parts"]`` names."""
    import _torch_mp_ranks
    return _torch_mp_ranks.run(rank, world, inp)


def case_elastic(rank, world, inp):
    """Elastic training, re-sharding and the capacity controller over a
    real trainer: the functions of ``tests/_torch_elastic_ranks.py`` that
    ``inp["parts"]`` names."""
    import _torch_elastic_ranks
    return _torch_elastic_ranks.run(rank, world, inp)


def case_obs(rank, world, inp):
    """Training telemetry and the cost model over real ranks: the
    functions of ``tests/_torch_obs_ranks.py`` that ``inp["parts"]``
    names."""
    import _torch_obs_ranks
    return _torch_obs_ranks.run(rank, world, inp)


def case_contrib_bn(rank, world, inp):
    """contrib.groupbn / cudnn_gbn with the statistics of every rank:
    outputs, running statistics and the gradients of sum(y * dy) (the
    parameters' summed over the ranks)."""
    import torch
    from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.utils.collectives import all_reduce_
    group = torch.distributed.group.WORLD
    c = inp["x"].shape[-1]
    out = {}
    for name, m in (
            ("groupbn", BatchNorm2d_NHWC(c, momentum=inp["momentum"],
                                         bn_group=world, process_group=group,
                                         device="cpu")),
            ("cudnn_gbn", GroupBatchNorm2d(c, group_size=world,
                                           process_group=group,
                                           momentum=inp["momentum"],
                                           device="cpu"))):
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(inp["w"]))
            m.bias.copy_(torch.from_numpy(inp["b"]))
        x = torch.from_numpy(inp["x"][rank]).requires_grad_()
        y = m(x)
        (y * torch.from_numpy(inp["dy"][rank])).sum().backward()
        out[name] = dict(
            y=_np(y), dx=_np(x.grad),
            dw=_np(all_reduce_(m.weight.grad.clone(), group)),
            db=_np(all_reduce_(m.bias.grad.clone(), group)),
            running=(_np(m.running_mean), _np(m.running_var)))
    return out


CASES = {"collectives": case_collectives, "mp": case_mp,
         "elastic": case_elastic, "obs": case_obs, "examples": case_examples, "ddp": case_ddp,
         "syncbn": case_syncbn, "zero": case_zero,
         "cpu_launches": case_cpu_launches, "tp": case_tp,
         "contrib_bn": case_contrib_bn}


def main():
    d, case, rank, world = sys.argv[1:5]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    with open(pathlib.Path(d) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = CASES[case](rank, world, inputs)
    if "jax" in sys.modules or any(m.startswith("apex_tpu.")
                                   for m in sys.modules):
        raise AssertionError("a rank imported JAX or the JAX package")
    dist.barrier()
    with open(pathlib.Path(d) / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
