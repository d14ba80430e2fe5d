"""The rank side of the expert-, context- and pipeline-parallel tests
(``tests/test_torch_moe*.py``, ``test_torch_context_parallel.py``,
``test_torch_pipeline*.py``): what one ``gloo`` rank of
``tests/_torch_dist.py``'s case ``mp`` runs.  It imports torch and
``apex_tpu_torch`` only; pytest does not collect it.  Each entry of
``inputs["parts"]`` names a function here and its numpy inputs; the
results come back as numpy."""

import torch
import torch.distributed as dist


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def _sd(tree):
    """A state dict of CPU tensors from numpy (copies: an optimizer step
    must not write into the inputs)."""
    return {k: torch.tensor(v) for k, v in tree.items()}


def moe_mlp_ep(rank, world, c):
    """``MoEMLP`` with its experts over the ``expert`` group: the local
    loss ``sum(out**2) + 0.01 * aux / ep`` (JAX's ``psum`` of the first
    term and ``pmean`` of the aux); the replicated gate's gradient summed
    over the group (JAX sums an invariant leaf's cotangents itself)."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.expert_parallel import MoEConfig, MoEMLP
    ps.initialize_model_parallel(expert_parallel_size_=world)
    m = MoEMLP(MoEConfig(hidden_size=c["h"], ffn_hidden_size=c["f"],
                         n_experts=c["e"], top_k=c["top_k"],
                         expert_parallel_size=world, axis_name="expert"),
               device="cpu")
    nl = c["e"] // world
    with torch.no_grad():
        m.gate.copy_(torch.tensor(c["gate"]))
        m.w1.copy_(torch.tensor(c["w1"][rank * nl:(rank + 1) * nl]))
        m.w2.copy_(torch.tensor(c["w2"][rank * nl:(rank + 1) * nl]))
    x = torch.tensor(c["x"][rank]).requires_grad_()
    out, aux = m(x)
    (torch.sum(out ** 2) + 0.01 * aux / world).backward()
    dist.all_reduce(m.gate.grad, group=ps.get_expert_parallel_group())
    ps.destroy_model_parallel()
    return dict(out=_np(out), aux=float(aux), dgate=_np(m.gate.grad),
                dw1=_np(m.w1.grad), dw2=_np(m.w2.grad), dx=_np(x.grad))


def gpt_ep(rank, world, c):
    """GPT MoE with the experts over the ``expert`` group (and the FFN of
    each expert over the ``model`` group when ``c["tp"] > 1``): each
    expert rank's rows, ``reduce_moe_grads``, the mean loss."""
    from apex_tpu_torch.convert import gpt_params_from_jax
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.expert_parallel import reduce_moe_grads
    tp = c["tp"]
    ep = world // tp
    ps.initialize_model_parallel(tp, expert_parallel_size_=ep)
    cfg = GPTConfig(**c["cfg"], expert_axis="expert", expert_parallel_size=ep,
                    tensor_parallel_size=tp,
                    axis_name="model" if tp > 1 else None)
    er, tr = ps.get_expert_parallel_rank(), ps.get_tensor_model_parallel_rank()
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(
        c["params"], cfg, rank=tr if tp > 1 else None, expert_rank=er))
    rows = c["tokens"].shape[0] // ep
    sl = slice(er * rows, (er + 1) * rows)
    loss = model.loss(torch.from_numpy(c["tokens"][sl]),
                      torch.from_numpy(c["targets"][sl]))
    loss.backward()
    reduce_moe_grads(model, "expert")
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=ps.get_expert_parallel_group())
    out = dict(loss=float(loss) / ep, grads=_grads(model),
               expert_rank=er, tp_rank=tr)
    ps.destroy_model_parallel()
    return out


def attention(rank, world, c):
    """Ring and Ulysses attention over the ``context`` group on this
    rank's sequence shard: the output and the gradients of ``sum(out**2)``
    (JAX's ``psum`` of it) for each mechanism and causality."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.context_parallel import (
        ring_attention, ulysses_attention)
    ps.initialize_model_parallel(context_parallel_size_=world)
    out = {}
    sl = c["q"].shape[2] // world
    for mech, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            for remat in ((True, False) if mech == "ring" else (True,)):
                qkv = [torch.tensor(c[k][:, :, rank * sl:(rank + 1) * sl])
                       .requires_grad_() for k in "qkv"]
                kw = dict(remat=remat) if mech == "ring" else {}
                y = fn(*qkv, "context", causal=causal, **kw)
                torch.sum(y.float() ** 2).backward()
                out[(mech, causal, remat)] = (_np(y),
                                              [_np(t.grad) for t in qkv])
    try:
        small = [torch.tensor(c["q"][:, :1, :sl]) for _ in range(3)]
        ulysses_attention(*small, "context")
        out["heads"] = "no error"
    except ValueError as e:
        out["heads"] = str(e)
    ps.destroy_model_parallel()
    return out


def gpt_cp(rank, world, c):
    """GPT with ``context_axis`` on this rank's sequence shard, both
    mechanisms: the loss and the gradients summed over the group (JAX's
    ``psum_if_varying`` of the partial gradients)."""
    from apex_tpu_torch.convert import gpt_params_from_jax
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.collectives import psum_if_varying
    ps.initialize_model_parallel(context_parallel_size_=world)
    out = {}
    sl = c["tokens"].shape[1] // world
    for mech in ("ring", "ulysses"):
        for cfg_kw in c["cfgs"]:
            cfg = GPTConfig(**cfg_kw, context_axis="context",
                            context_mechanism=mech)
            model = GPTModel(cfg, device="cpu")
            model.load_state_dict(gpt_params_from_jax(
                c["params"][cfg_kw["rotary"]], cfg))
            loss = model.loss(
                torch.from_numpy(c["tokens"][:, rank * sl:(rank + 1) * sl]),
                torch.from_numpy(c["targets"][:, rank * sl:(rank + 1) * sl]))
            loss.backward()
            names = [n for n, _ in model.named_parameters()]
            summed = psum_if_varying([p.grad for p in model.parameters()],
                                     "context")
            out[(mech, cfg_kw["rotary"])] = (
                float(loss), {n: _np(g) for n, g in zip(names, summed)})
    ps.destroy_model_parallel()
    return out


def pipeline(rank, world, c):
    """``pipeline_step`` over a ``pipe`` group of ``world / tp`` ranks
    (``tp`` model ranks a stage, sequence parallel), for each run of
    ``c["runs"]``: this rank's loss and gradients (names of its stage
    model)."""
    from apex_tpu_torch.convert import gpt_params_from_jax
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, pipeline_step
    from apex_tpu_torch.transformer import parallel_state as ps
    out = {}
    for name, run in c["runs"].items():
        tp = run.get("tp", 1)
        ps.initialize_model_parallel(tp, world // tp)
        stages = world // tp
        s = ps.get_pipeline_model_parallel_rank()
        kw = dict(run["cfg"])
        if tp > 1:
            kw.update(tensor_parallel_size=tp, axis_name="model",
                      sequence_parallel=True)
        cfg = GPTConfig(**kw)
        stage = (stages, run["v"], s)
        model = GPTModel(cfg, device="cpu", pipeline_stage=stage)
        model.load_state_dict(gpt_params_from_jax(
            c["params"][run["params"]], cfg,
            rank=ps.get_tensor_model_parallel_rank() if tp > 1 else None,
            pipeline_stage=stage))
        losses = []
        for seed in run.get("seeds", [None]):
            model.zero_grad(set_to_none=True)
            losses.append(float(pipeline_step(
                model, torch.from_numpy(c["tokens"]),
                torch.from_numpy(c["targets"]), n_virtual=run["v"],
                dropout_seed=seed)))
        out[name] = dict(losses=losses, grads=_grads(model), stage=s,
                         tp_rank=ps.get_tensor_model_parallel_rank())
        ps.destroy_model_parallel()
    return out


def p2p(rank, world, c):
    """The half-ops of ``p2p_communication`` at ``world`` stages: forward
    and backward shifts with and without the wrap, and the gradient of
    ``sum(shift(x) * w)`` (the counter-rotating shift)."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as P)
    ps.initialize_model_parallel(1, world)
    out = {}
    for name, fn in (("fwd", P.send_forward_recv_forward),
                     ("bwd", P.send_backward_recv_backward)):
        for wrap in (False, True):
            x = torch.tensor(c["x"][rank]).requires_grad_()
            y = fn(x, wrap=wrap)
            torch.sum(y * torch.tensor(c["w"][rank])).backward()
            out[(name, wrap)] = (_np(y), _np(x.grad))
    ps.destroy_model_parallel()
    return out


def run(rank, world, inp):
    return {name: globals()[name](rank, world, c)
            for name, c in inp["parts"].items()}
