"""Per-collective byte accounting of one call — port of
``apex_tpu/observability/comms.py``.

The dp/tp/SP legs report *time*; this reports the *payload bytes* behind
it.  JAX reads them from the optimized HLO of the compiled program; eager
PyTorch has no such program, so :func:`collective_stats` runs the call once
under a ``TorchDispatchMode`` that sees the ``c10d`` ops
:mod:`torch.distributed` dispatches (the counting
``torch.distributed.tensor.debug.CommDebugMode`` does, in a small mode of
its own), and reports per-kind op counts and bytes of that call.

Byte accounting per op = the LARGEST tensor on the op (result or operand),
which matches the payload each collective moves — the reference's rule:

* ``all_reduce``     — the reduced tensor (``allreduce_``);
* ``all_gather``     — the gathered RESULT (``_allgather_base_``, or the
  output list of ``allgather_`` summed);
* ``reduce_scatter`` — the full OPERAND (``_reduce_scatter_base_``, or
  the input list of ``reduce_scatter_`` summed);
* ``collective_permute`` — a ``send`` of ``batch_isend_irecv`` /
  ``isend`` / ``send``: the sent tensor.  Its ``recv`` is the other half
  of a peer's send and is not counted again, so the ranks' counts add up
  to one op per transfer;
* ``all_to_all``     — the exchanged tensor (``alltoall_base_``, or the
  input list of ``alltoall_`` summed).

The functional collectives (``_c10d_functional``) count the same way.
Other ``c10d`` ops (``broadcast_``, ``barrier``, ...) have no kind here:
they are listed, by op name, under ``"dispatched"`` with every counted one.
The returned bytes are payload bytes; actual wire traffic depends on the
algorithm (a ring all-reduce moves ~2x(k-1)/k of payload per link) —
:func:`wire_bytes` applies that standard ring model when a group size is
known.

Each op's ``scope`` is the innermost name open under
:func:`apex_tpu_torch.utils.profiling.annotate` / ``range_push`` (an
:func:`~apex_tpu_torch.observability.spans.span` opens one too) when it
was issued.  The JAX package's ``hlo_collective_stats`` parses HLO text
and has no counterpart: there is no HLO.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.utils.profiling import current_scope, range_stack

COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "collective_permute", "all_to_all")

# op name (namespace::name, without the overload) -> (kind, byte rule).
# Byte rules: "max" the largest tensor on the op; "out_list" / "in_list"
# the summed first list of output / input tensors (a gathered result or a
# full scattered operand given as pieces); None: not counted (a recv).
_C10D_OPS = {
    "c10d::allreduce_": ("all_reduce", "max"),
    "c10d::allreduce_coalesced_": ("all_reduce", "max"),
    "c10d::_allgather_base_": ("all_gather", "max"),
    "c10d::allgather_": ("all_gather", "out_list"),
    "c10d::allgather_coalesced_": ("all_gather", "out_list"),
    "c10d::allgather_into_tensor_coalesced_": ("all_gather", "max"),
    "c10d::_reduce_scatter_base_": ("reduce_scatter", "max"),
    "c10d::reduce_scatter_": ("reduce_scatter", "in_list"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce_scatter", "max"),
    "c10d::send": ("collective_permute", "max"),
    "c10d::recv_": ("collective_permute", None),
    "c10d::recv_any_source_": ("collective_permute", None),
    "c10d::alltoall_base_": ("all_to_all", "max"),
    "c10d::alltoall_": ("all_to_all", "in_list"),
    "_c10d_functional::all_reduce": ("all_reduce", "max"),
    "_c10d_functional::all_reduce_": ("all_reduce", "max"),
    "_c10d_functional::all_reduce_coalesced": ("all_reduce", "max"),
    "_c10d_functional::all_gather_into_tensor": ("all_gather", "max"),
    "_c10d_functional::all_gather_into_tensor_out": ("all_gather", "max"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all_gather",
                                                           "max"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce_scatter", "max"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce_scatter",
                                                          "max"),
    "_c10d_functional::all_to_all_single": ("all_to_all", "max"),
}
_NAMESPACES = ("c10d", "_c10d_functional")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat_tensors(x) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _first_list(args):
    """The first list (or list of lists) argument's tensors."""
    for a in args:
        if isinstance(a, (list, tuple)):
            ts = _flat_tensors(a)
            if ts:
                return ts
    return []


def _group_size(args, kwargs):
    """The size of the process group among the op's arguments (a boxed
    ``ProcessGroup``, or the functional ops' group name), or None."""
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return int(dist.ProcessGroup.unbox(a).size())
            except RuntimeError:       # not a process group
                continue
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group)
                return int(_resolve_process_group(a).size())
            except (KeyError, RuntimeError, ValueError):   # not a group name
                continue
    return None


def _op_bytes(rule, args, kwargs, out) -> int:
    if rule == "out_list":
        return sum(_nbytes(t) for t in _first_list(args))
    if rule == "in_list":
        lists = [a for a in args if isinstance(a, (list, tuple))
                 and _flat_tensors(a)]
        ts = _flat_tensors(lists[1]) if len(lists) > 1 else []
        return sum(_nbytes(t) for t in ts)
    sizes = [_nbytes(t) for t in _flat_tensors((args, kwargs, out))]
    return max(sizes, default=0)


def _empty_stats() -> Dict[str, dict]:
    return {k: {"count": 0, "bytes": 0, "ops": []} for k in COLLECTIVE_KINDS}


class _CommMode(TorchDispatchMode):
    """Records every ``c10d`` op dispatched while it is active; an op on a
    thread with no open range (autograd's device thread) takes its scope
    from the ranges of the thread that entered the mode."""

    def __init__(self):
        super().__init__()
        self._home = range_stack()
        self.stats = _empty_stats()
        self.dispatched = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _NAMESPACES:
            name = func._schema.name
            self.dispatched[name] += 1
            kind, rule = _C10D_OPS.get(name, (None, None))
            if rule is not None:
                nbytes = _op_bytes(rule, args, kwargs, out)
                row = self.stats[kind]
                row["count"] += 1
                row["bytes"] += nbytes
                row["ops"].append({"bytes": nbytes,
                                   "group_size": _group_size(args, kwargs),
                                   "scope": current_scope(self._home),
                                   "op": name})
        return out


def collective_stats(fn: Callable, *args, **kwargs) -> Dict[str, dict]:
    """Run ``fn(*args, **kwargs)`` once and account the collectives it
    issues on this rank.

    Returns ``{kind: {"count", "bytes", "ops": [{"bytes", "group_size",
    "scope", "op"}, ...]}}`` for the five kinds, a ``"total"`` row, and
    ``"dispatched"``: every ``c10d`` op seen, by name, with its count.
    ``bytes`` is payload bytes of the one call; ``op`` names the ``c10d``
    op each entry came from.  A group of one rank still dispatches its
    collectives, so they are counted.
    """
    mode = _CommMode()
    with mode:
        fn(*args, **kwargs)
    out: Dict[str, dict] = dict(mode.stats)
    out["total"] = {
        "count": sum(out[k]["count"] for k in COLLECTIVE_KINDS),
        "bytes": sum(out[k]["bytes"] for k in COLLECTIVE_KINDS),
    }
    out["dispatched"] = dict(mode.dispatched)
    return out


def wire_bytes(stats: Dict[str, dict]) -> int:
    """Estimated bytes actually crossing links per step, under the
    standard ring algorithms: all-reduce moves ``2*(k-1)/k`` of its
    payload, all-gather/reduce-scatter ``(k-1)/k``, permute/all-to-all
    the payload itself.  Ops without a parsed group size fall back to
    the worst case (factor 2 / 1 / 1)."""
    factors = {"all_reduce": lambda k: 2 * (k - 1) / k if k else 2.0,
               "all_gather": lambda k: (k - 1) / k if k else 1.0,
               "reduce_scatter": lambda k: (k - 1) / k if k else 1.0,
               "collective_permute": lambda k: 1.0,
               "all_to_all": lambda k: 1.0}
    total = 0.0
    for kind, f in factors.items():
        for op in stats.get(kind, {}).get("ops", ()):
            total += op["bytes"] * f(op.get("group_size"))
    return int(total)


def format_stats(stats: Dict[str, dict], *,
                 by_scope: bool = False) -> str:
    """Human-readable table of a :func:`collective_stats` result.
    ``by_scope=True`` appends a per-scope breakdown under each kind,
    attributing bytes back to the issuing code."""
    lines = [f"{'collective':<20} {'count':>5} {'payload bytes':>14}"]
    for kind in sorted(stats):
        if kind in ("total", "dispatched"):
            continue
        row = stats[kind]
        if row["count"]:
            lines.append(f"{kind:<20} {row['count']:>5} "
                         f"{row['bytes']:>14,}")
            if by_scope:
                per: Dict[str, tuple] = {}
                for op in row.get("ops", ()):
                    s = op.get("scope") or "<no scope>"
                    c, b = per.get(s, (0, 0))
                    per[s] = (c + 1, b + op["bytes"])
                for s, (c, b) in sorted(per.items(),
                                        key=lambda kv: -kv[1][1]):
                    lines.append(f"  {s:<18} {c:>5} {b:>14,}")
    t = stats.get("total", {})
    lines.append(f"{'total':<20} {t.get('count', 0):>5} "
                 f"{t.get('bytes', 0):>14,} "
                 f"(~{wire_bytes(stats):,} wire)")
    return "\n".join(lines)
