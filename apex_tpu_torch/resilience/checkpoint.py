"""Atomic, content-hashed, shard-aware checkpointing — port of
``apex_tpu/resilience/checkpoint.py``.

Layout (one directory per step), the JAX package's::

    <dir>/step_00000012/
        state.bin        packed payload (native parallel write)
        MANIFEST.json    leaf/shard table + sha256 of state.bin
    <dir>/latest -> step_00000012

Commit protocol — survives a kill at ANY point:

1. everything is written into ``step_N.tmp`` (an unfinished tmp dir is
   never a restore candidate) and the payload is fsynced;
2. ``MANIFEST.json`` (carrying the payload's sha256) is written LAST and
   fsynced — a dir without a manifest is ignored;
3. the tmp dir is renamed to ``step_N`` (atomic on POSIX);
4. ``latest`` is repointed via a tmp symlink + ``os.replace`` (atomic).

Restore verifies the payload hash against the manifest; a mismatch (a torn
or bit-flipped write that still managed to commit) discards that candidate
and falls back to the previous complete checkpoint.

**The state** is a nest of dicts, lists, tuples and NamedTuples whose leaves
are tensors (any device), numpy arrays or Python numbers.  Dict keys
flatten in sorted order and NamedTuples as their fields, as
``jax.tree_util`` flattens them, so a tree of the same shape has the same
leaf order in both packages; ``None`` is an empty subtree.  bf16 leaves are
stored as their bytes under the dtype name ``bfloat16``.  In one process
(``group=None``) the layout is exactly the JAX package's, so either package
reads the other's checkpoint.

**Ranks are processes.**  A :class:`ShardedLeaf` is one rank's block of a
global array (a ZeRO optimizer's rows).  With ``group`` (a process group of
more than one rank) every rank writes and fsyncs its own file —
``state.bin`` for the group's rank 0, ``state.r<k>.bin`` for rank ``k`` —
holding its shards and, on rank 0 only, the replicated leaves; the ranks
gather their shard tables, and rank 0 writes the manifest (JAX's per-leaf
table of global shape and, per shard, the global index, offset and nbytes,
plus the ``file`` holding it, and each file's sha256 under ``files``) and
commits with the same rename, after which every rank leaves :meth:`save`
together.  :meth:`restore` takes rank 0's candidate list, and each
candidate is used only when every rank read it hash-valid, so all ranks
restore the same step; a :class:`ShardedLeaf` template receives its block
of the saved global array, whatever the saving world size was (the restore
re-shards).

**Async** (:meth:`save_async`): tensors are mutable, so the snapshot is not
free as in JAX — the caller's thread copies every leaf into the host payload
before :meth:`save_async` returns (the next optimizer step cannot write into
the checkpoint being saved); the hash, the write and the commit run on a
writer thread, at most two in flight.  With ``group``, the save runs on the
caller's thread: collectives from a writer thread would race the training
step's collectives on the same group.

**Host buffers.**  Where the state has CUDA tensors, the payload is a
page-locked host buffer that the manager keeps for its next save or
restore (at most two, for ``save_async``'s double buffering; they go with
the manager): the card copies into and out of it at its full rate, and no
save pays for the first touch of fresh memory.  A save hashes while it writes; a
restore hashes each chunk as the parallel read delivers it and copies the
leaves to the card while the hash finishes, and nothing is returned before
the hash matches.

:attr:`CheckpointManager.last_save` / :attr:`~CheckpointManager.
last_restore` hold the last call's bytes, seconds, GB/s and sha256 seconds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.utils import native

_FORMAT = 1
_PAYLOAD = "state.bin"
_MANIFEST = "MANIFEST.json"
_LATEST = "latest"

__all__ = ["CheckpointManager", "CheckpointNotFound", "ShardedLeaf",
           "tree_flatten", "tree_unflatten"]

_READ_CHUNK = 256 << 20        # bytes a restore reads before hashing them


class _HostBuffers:
    """A manager's page-locked host buffers: the newest two given back are
    kept for its next saves and restores."""

    def __init__(self):
        self._free: list = []
        self._lock = threading.Lock()

    def take(self, nbytes: int, pinned: bool):
        """``(array, owner)``: a uint8 host buffer of ``nbytes``, page-locked
        when ``pinned`` (``owner`` goes back with :meth:`give`), else plain
        numpy (``owner`` None)."""
        if not pinned or nbytes == 0:
            return np.empty((nbytes,), np.uint8), None
        owner = None
        with self._lock:
            for i, b in enumerate(self._free):
                if b.numel() == nbytes:
                    owner = self._free.pop(i)
                    break
        if owner is None:
            owner = torch.empty((nbytes,), dtype=torch.uint8,
                                pin_memory=True)
        return owner.numpy(), owner

    def give(self, owner) -> None:
        if owner is not None:
            with self._lock:
                self._free = (self._free + [owner])[-2:]


def _on_cuda(leaves) -> bool:
    return any(isinstance(getattr(x, "data", x), torch.Tensor)
               and getattr(x, "data", x).is_cuda for x in leaves)


class CheckpointNotFound(FileNotFoundError):
    """No complete, hash-valid checkpoint exists in the directory."""


@dataclasses.dataclass
class ShardedLeaf:
    """One rank's block of a global array: ``data`` (a tensor or numpy
    array) holds rows ``index`` (a ``(start, stop)`` pair per dimension)
    of an array of ``shape``."""
    data: Any
    shape: tuple
    index: tuple


# -- tree flattening (jax.tree_util's leaf order) -----------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[list, Any]:
    """``(leaves, treedef)``: dicts by sorted key, lists and tuples in
    order, NamedTuples by field, ``None`` no leaf."""
    leaves: list = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", type(x), tuple(keys),
                    tuple(walk(x[k]) for k in keys))
        if _is_namedtuple(x):
            return ("nt", type(x), tuple(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), tuple(walk(v) for v in x))
        leaves.append(x)
        return ("leaf",)
    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return d[1](zip(d[2], (build(s) for s in d[3])))
        if kind == "nt":
            return d[1](*(build(s) for s in d[2]))
        return d[1](build(s) for s in d[2])
    return build(treedef)


def _describe(treedef) -> str:
    """A readable form of the tree, in the spirit of JAX's ``PyTreeDef``
    string (neither package reads it back)."""
    kind = treedef[0]
    if kind == "none":
        return "None"
    if kind == "leaf":
        return "*"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(s)}"
                               for k, s in zip(treedef[2], treedef[3])) + "}"
    inner = ", ".join(_describe(s) for s in treedef[-1])
    if kind == "nt":
        return f"CustomNode(namedtuple[{treedef[1].__name__}], [{inner}])"
    return f"[{inner}]" if treedef[1] is list else f"({inner})"


# -- leaves as bytes ------------------------------------------------------------

_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def _np_storage(name: str) -> np.dtype:
    """The numpy dtype that holds a saved dtype's bytes (bf16 as int16)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return _TORCH_NAMES[x.dtype]
    return str(np.asarray(x).dtype)


def _shape(x) -> tuple:
    return tuple(int(d) for d in (x.shape if hasattr(x, "shape")
                                  else np.shape(x)))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _copy_into(dst: np.ndarray, x) -> None:
    """Copy leaf ``x`` into the uint8 payload slice ``dst`` (a tensor by
    the card's copy engine or torch's copy; numpy by the native pack)."""
    if isinstance(x, torch.Tensor):
        if x.numel() == 0:
            return
        src = x.detach()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        view = torch.from_numpy(dst).view(src.dtype).view(src.shape)
        view.copy_(src, non_blocking=src.is_cuda)
    else:
        native.pack([np.asarray(x)], out=dst)


def _entries(leaf, write_replicated: bool):
    """``[(index, data, global_shape)]`` this process writes for ``leaf``."""
    if isinstance(leaf, ShardedLeaf):
        return [(tuple(tuple(int(v) for v in p) for p in leaf.index),
                 leaf.data, tuple(int(d) for d in leaf.shape))]
    shape = _shape(leaf)
    if not write_replicated:
        return []
    return [(tuple((0, d) for d in shape), leaf, shape)]


def _group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def _group_rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _gather(obj, group):
    import torch.distributed as dist
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(buf: np.ndarray, box: dict) -> None:
    t0 = time.perf_counter()
    box["digest"] = hashlib.sha256(memoryview(buf)).hexdigest()
    box["seconds"] = time.perf_counter() - t0


def _hash_chunks(work, boxes: dict) -> None:
    """Hash each file's chunks in the order they arrive on ``work``
    (``(name, chunk)``; ``(name, None)`` ends a file, None the stream)."""
    hashers, spent = {}, {}
    while True:
        item = work.get()
        if item is None:
            return
        name, chunk = item
        t0 = time.perf_counter()
        h = hashers.setdefault(name, hashlib.sha256())
        if chunk is None:
            boxes[name] = {"digest": h.hexdigest(),
                           "seconds": spent.get(name, 0.0)}
            continue
        h.update(memoryview(chunk))
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0


class _Snapshot:
    """A state's bytes on the host: the payload this process writes, its
    shard table, and the per-leaf shapes and dtypes."""

    def __init__(self, state, write_replicated: bool, buffers):
        leaves, treedef = tree_flatten(state)
        self.treedef = _describe(treedef)
        self.recs, self.entries = [], []
        offset = 0
        for leaf in leaves:
            data = leaf.data if isinstance(leaf, ShardedLeaf) else leaf
            shards = []
            shape = None
            for idx, part, shape in _entries(leaf, write_replicated):
                n = _nbytes(part)
                shards.append({"index": [list(p) for p in idx],
                               "offset": offset, "nbytes": n})
                self.entries.append((offset, n, part))
                offset += n
            if shape is None:
                shape = (tuple(leaf.shape) if isinstance(leaf, ShardedLeaf)
                         else _shape(leaf))
            self.recs.append({"shape": [int(d) for d in shape],
                              "dtype": _dtype_name(data), "shards": shards})
        cuda = _on_cuda(leaves)
        self.payload, self.owner = buffers.take(offset, cuda)
        for off, n, part in self.entries:
            _copy_into(self.payload[off:off + n], part)
        if cuda:
            torch.cuda.synchronize()
        self.entries = None


class CheckpointManager:
    """Atomic checkpoint store rooted at ``directory``.

    ``keep`` complete checkpoints are retained (older ones are deleted after
    each successful commit — the fallback chain needs at least 2).
    ``fault_injector`` threads :class:`~apex_tpu_torch.resilience.faults.
    FaultInjector` through the IO path: a scheduled ``corrupt_checkpoint``
    at the saved step flips payload bytes AFTER the commit, producing
    exactly the torn write the hash check must catch.

    ``topology`` (a :class:`~apex_tpu_torch.resilience.elastic.
    TopologySpec` or its dict form; mutable — the elastic trainer updates it
    on every re-plan) is stamped into each manifest together with the mesh
    shape; ``parallel_plan`` (a :class:`~apex_tpu_torch.parallel.plan.
    ParallelPlan` or its dict form) under its own key.  ``group`` is the
    process group whose ranks save and restore together (None: this
    process alone); mutable like ``topology``.
    """

    def __init__(self, directory: str, *, keep: int = 2, threads: int = 4,
                 fault_injector=None, topology=None, parallel_plan=None,
                 group=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = str(directory)
        self.keep = int(keep)
        self.threads = int(threads)
        self.fault_injector = fault_injector
        self.topology = topology
        self.parallel_plan = parallel_plan
        self.group = group
        os.makedirs(self.directory, exist_ok=True)
        self._pending: list = []          # [(step, thread, box)]
        self._lock = threading.Lock()
        self._commit_lock = threading.Lock()
        self.last_save: Optional[dict] = None
        self.last_restore: Optional[dict] = None
        self._buffers = _HostBuffers()

    def _topology_dict(self) -> Optional[dict]:
        t = self.topology
        if t is None:
            return None
        return t.to_dict() if hasattr(t, "to_dict") else dict(t)

    def _plan_dict(self) -> Optional[dict]:
        p = self.parallel_plan
        if p is None:
            return None
        return p.to_dict() if hasattr(p, "to_dict") else dict(p)

    def _multi(self) -> bool:
        return _group_size(self.group) > 1

    # -- enumeration --------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Committed step numbers, ascending (manifest presence only —
        hash validity is restore's concern)."""
        steps = []
        for name in os.listdir(self.directory):
            s = _parse_step(name)
            if s is not None and os.path.exists(
                    os.path.join(self.directory, name, _MANIFEST)):
                steps.append(s)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest_key(self, step: int, key: str):
        mpath = os.path.join(self.directory, _step_dirname(step), _MANIFEST)
        try:
            with open(mpath) as f:
                return json.load(f).get(key)
        except (OSError, ValueError):
            return None

    def topology_of(self, step: int) -> Optional[dict]:
        """The topology dict stamped into ``step``'s manifest (``None``
        for checkpoints saved without one) — manifest-only, no payload
        read, so a restart can pick its restore layout cheaply."""
        return self._manifest_key(step, "topology")

    def plan_of(self, step: int) -> Optional[dict]:
        """The parallel-plan dict stamped into ``step``'s manifest
        (``None`` when saved without one) — manifest-only."""
        return self._manifest_key(step, "parallel_plan")

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state) -> str:
        """Write and commit a checkpoint for ``step``; returns the
        committed directory path."""
        t0 = time.perf_counter()
        snap = _Snapshot(state, _group_rank(self.group) == 0,
                         self._buffers)
        return self._commit(step, snap, t0, time.perf_counter() - t0)

    def _manifest(self, step, snap, digest, treedef, recs) -> dict:
        manifest = {"format": _FORMAT, "step": int(step), "sha256": digest,
                    "nbytes": int(snap.payload.nbytes), "treedef": treedef,
                    "leaves": recs}
        topo = self._topology_dict()
        if topo is not None:
            manifest["topology"] = topo
            manifest["mesh_shape"] = {"data": topo.get("dp", 1),
                                      "pipe": topo.get("pp", 1),
                                      "model": topo.get("tp", 1)}
        plan = self._plan_dict()
        if plan is not None:
            manifest["parallel_plan"] = plan
        return manifest

    def _write_payload(self, path: str, payload: np.ndarray) -> dict:
        """Write + fsync ``payload`` while a second thread hashes it."""
        box: dict = {}
        hasher = threading.Thread(target=_sha256, args=(payload, box))
        hasher.start()
        t0 = time.perf_counter()
        native.file_write(path, payload, threads=self.threads)
        _fsync(path)
        write_s = time.perf_counter() - t0
        hasher.join()
        return {"sha256": box["digest"], "nbytes": int(payload.nbytes),
                "write_s": write_s, "sha256_s": box["seconds"]}

    def _commit(self, step: int, snap: _Snapshot, t0: float,
                snapshot_s: float) -> str:
        try:
            return self._write_and_commit(step, snap, t0, snapshot_s)
        finally:
            self._buffers.give(snap.owner)
            snap.payload = snap.owner = None

    def _write_and_commit(self, step: int, snap: _Snapshot, t0: float,
                          snapshot_s: float) -> str:
        nbytes = int(snap.payload.nbytes)
        group = self.group
        multi = self._multi()
        rank = _group_rank(group)
        final = os.path.join(self.directory, _step_dirname(step))
        tmp = final + ".tmp"
        if rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        if multi:
            import torch.distributed as dist
            dist.barrier(group=group)
        fname = _PAYLOAD if rank == 0 else f"state.r{rank}.bin"
        info = self._write_payload(os.path.join(tmp, fname), snap.payload)
        recs = snap.recs
        if multi:
            # rank 0 merges every rank's shard table (a shard once: the
            # first rank that holds an index keeps it)
            tables = _gather((fname, info, recs), group)
            files = {name: {"sha256": i["sha256"], "nbytes": i["nbytes"]}
                     for name, i, _ in tables}
            merged = [dict(r, shards=[]) for r in tables[0][2]]
            for li, rec in enumerate(merged):
                seen = set()
                for name, _, table in tables:
                    for sh in table[li]["shards"]:
                        key = tuple(map(tuple, sh["index"]))
                        if key not in seen:
                            seen.add(key)
                            rec["shards"].append(dict(sh, file=name))
            recs = merged
        if rank == 0:
            manifest = self._manifest(step, snap, info["sha256"],
                                      snap.treedef, recs)
            if multi:
                manifest["files"] = files
                manifest["world"] = _group_size(group)
            mpath = os.path.join(tmp, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            # writer threads commit one at a time (the latest link and the
            # retirement scan are shared)
            with self._commit_lock:
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._point_latest(final)
                inj = self.fault_injector
                if inj is not None and inj.should_corrupt(step):
                    _corrupt_payload(os.path.join(final, _PAYLOAD))
                    inj.record(step, "corrupt_checkpoint")
                self._retire()
        if multi:
            import torch.distributed as dist
            dist.barrier(group=group)
        seconds = time.perf_counter() - t0
        self.last_save = {"step": int(step), "bytes": nbytes,
                          "seconds": seconds, "snapshot_s": snapshot_s,
                          "write_s": info["write_s"],
                          "sha256_s": info["sha256_s"],
                          "gb_per_s": nbytes / 1e9 / seconds}
        return final

    def _point_latest(self, final: str) -> None:
        link = os.path.join(self.directory, _LATEST)
        tmp = link + ".tmp"
        if os.path.lexists(tmp):
            os.unlink(tmp)
        os.symlink(os.path.basename(final), tmp)
        os.replace(tmp, link)

    def _retire(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, _step_dirname(s)),
                          ignore_errors=True)

    # -- async double-buffered save -----------------------------------------

    def save_async(self, step: int, state) -> None:
        """Snapshot ``state`` to the host now, then hash, write and commit
        on a writer thread.  At most two saves run ahead of the caller; a
        third call blocks on the oldest.  With a ``group`` of several ranks
        the whole save runs here (see the module docstring)."""
        if self._multi():
            self.wait()
            self.save(step, state)
            return
        with self._lock:
            while len(self._pending) >= 2:
                self._join_oldest()
            t0 = time.perf_counter()
            snap = _Snapshot(state, True, self._buffers)
            snapshot_s = time.perf_counter() - t0
            box = {}

            def work():
                try:
                    box["path"] = self._commit(step, snap, t0, snapshot_s)
                except BaseException as e:          # surfaced on wait()
                    box["error"] = e

            t = threading.Thread(target=work, daemon=True,
                                 name=f"ckpt-save-{step}")
            t.start()
            self._pending.append((step, t, box))

    def _join_oldest(self) -> None:
        step, t, box = self._pending.pop(0)
        t.join()
        if "error" in box:
            raise box["error"]

    def wait(self) -> None:
        """Block until every queued async save has committed (re-raises
        the first writer error)."""
        with self._lock:
            while self._pending:
                self._join_oldest()

    # -- restore ------------------------------------------------------------

    def restore(self, template, *, step: Optional[int] = None,
                topology=None) -> Tuple[Any, int]:
        """Load the newest complete, hash-valid checkpoint.

        ``template`` supplies the tree structure and each leaf's target: a
        tensor template gives a tensor of the saved dtype on its device, a
        :class:`ShardedLeaf` its block of the saved global array (on its
        data's device), anything else a numpy array.  ``step`` pins a
        checkpoint instead of the newest.  ``topology`` declares the layout
        the caller restores INTO; when it differs from the manifest's stamp
        a warning names BOTH (the state is still loaded: the templates
        define placement, and :func:`~apex_tpu_torch.resilience.elastic.
        reshard_optimizer_state` must run before layout-dependent state is
        used).  Returns ``(state, step)``; raises
        :class:`CheckpointNotFound` when no candidate survives the hash
        check on every rank.
        """
        multi = self._multi()
        candidates = ([step] if step is not None
                      else sorted(self.all_steps(), reverse=True))
        if multi:
            candidates = _gather(candidates, self.group)[0]
        t_leaves, treedef = tree_flatten(template)
        for s in candidates:
            t0 = time.perf_counter()
            path = os.path.join(self.directory, _step_dirname(s))
            try:
                out, manifest, stats = self._load_dir(path, t_leaves)
                error = None
            except (OSError, ValueError, KeyError) as e:
                out, error = None, e
            if multi:
                errors = _gather(None if error is None else str(error),
                                 self.group)
                bad = [e for e in errors if e is not None]
                if bad and error is None:
                    error = ValueError(f"another rank: {bad[0]}")
            if error is not None:
                warnings.warn(
                    f"checkpoint {path} is corrupt or torn ({error}); "
                    "falling back to the previous complete checkpoint",
                    stacklevel=2)
                continue
            if topology is not None:
                want = (topology.to_dict() if hasattr(topology, "to_dict")
                        else dict(topology))
                saved = manifest.get("topology")
                if saved is not None and saved != want:
                    warnings.warn(
                        f"checkpoint {path} was saved under topology "
                        f"{saved} but is being restored onto {want}; "
                        "optimizer state must be re-sharded "
                        "(reshard_optimizer_state) before use",
                        stacklevel=2)
            seconds = time.perf_counter() - t0
            self.last_restore = dict(stats, step=int(s), seconds=seconds,
                                     gb_per_s=stats["bytes"] / 1e9 / seconds)
            return tree_unflatten(treedef, out), s
        raise CheckpointNotFound(
            f"no complete checkpoint under {self.directory!r} "
            f"(candidates tried: {candidates})")

    def _load_dir(self, path: str, t_leaves):
        """The template's leaves from ``path``, its manifest and the read's
        statistics.  Every file's hash is checked (on a second thread,
        while the leaves are built) before anything is returned."""
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        files = manifest.get("files") or {
            _PAYLOAD: {"sha256": manifest["sha256"],
                       "nbytes": manifest["nbytes"]}}
        recs = manifest["leaves"]
        if len(recs) != len(t_leaves):
            raise ValueError(f"{len(recs)} leaves, the template has "
                             f"{len(t_leaves)}")
        t0 = time.perf_counter()
        pinned = _on_cuda(t_leaves)
        payloads, owners, work, boxes = {}, [], queue.Queue(), {}
        hasher = threading.Thread(target=_hash_chunks, args=(work, boxes))
        hasher.start()
        try:
            for name, want in files.items():
                fpath = os.path.join(path, name)
                size = os.path.getsize(fpath)
                if size != want["nbytes"]:
                    raise ValueError(
                        f"{name} is {size} bytes, manifest says "
                        f"{want['nbytes']} (torn write)")
                payload, owner = self._buffers.take(size, pinned)
                payloads[name] = payload
                owners.append(owner)
                for lo in range(0, size, _READ_CHUNK):
                    chunk = payload[lo:lo + _READ_CHUNK]
                    native.read_into(fpath, chunk, lo, self.threads)
                    work.put((name, chunk))
                work.put((name, None))
            read_s = time.perf_counter() - t0
            out = [self._leaf(rec, tl, payloads)
                   for rec, tl in zip(recs, t_leaves)]
        finally:
            work.put(None)
            hasher.join()
            if pinned:
                torch.cuda.synchronize()    # no copy still reads a buffer
            for owner in owners:
                self._buffers.give(owner)
        for name, want in files.items():
            digest = boxes[name]["digest"]
            if digest != want["sha256"]:
                raise ValueError(
                    f"payload hash {digest[:12]}… does not match manifest "
                    f"{want['sha256'][:12]}… (corrupt write)")
        nbytes = sum(p.nbytes for p in payloads.values())
        return out, manifest, {
            "bytes": int(nbytes), "read_s": read_s,
            "sha256_s": sum(b["seconds"] for b in boxes.values())}

    @staticmethod
    def _leaf(rec, template, payloads):
        name = rec["dtype"]
        dt = _np_storage(name)
        shape = tuple(int(d) for d in rec["shape"])
        shards = rec["shards"]

        def part(sh):
            buf = payloads[sh.get("file", _PAYLOAD)]
            raw = buf[sh["offset"]:sh["offset"] + sh["nbytes"]]
            if sh["offset"] % dt.itemsize:
                raw = raw.copy()
            return raw.view(dt)

        want = None
        if isinstance(template, ShardedLeaf):
            want = tuple(tuple(int(v) for v in p) for p in template.index)
        whole = tuple((0, d) for d in shape)
        hit = [sh for sh in shards
               if tuple(map(tuple, sh["index"])) == (want or whole)]
        if hit:                                   # no assembly needed
            arr = part(hit[0]).reshape([b - a for a, b in (want or whole)])
        else:
            full = np.empty(shape, dt)
            for sh in shards:
                sl = tuple(slice(a, b) for a, b in sh["index"])
                full[sl] = part(sh).reshape(full[sl].shape)
            arr = (full if want is None
                   else full[tuple(slice(a, b) for a, b in want)])
        if isinstance(template, ShardedLeaf):
            data = _to_like(arr, name, template.data)
            return ShardedLeaf(data, shape, want)
        return _to_like(arr, name, template)


def _to_like(arr: np.ndarray, name: str, template):
    """``arr`` (saved dtype ``name``) as the template's kind: a tensor on
    the template's device, else a numpy array (bf16 kept as its bytes'
    int16 view only where no tensor is wanted)."""
    if not isinstance(template, torch.Tensor):
        return np.array(arr)
    # a view of the payload (copied below); a 0-d array stays 0-d
    t = torch.from_numpy(arr if arr.ndim and arr.flags.c_contiguous
                         else np.array(arr))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    elif name == "bool":
        t = t.to(torch.bool)
    return t.to(template.device, copy=True,
                non_blocking=template.device.type == "cuda")


def _corrupt_payload(path: str, n: int = 64) -> None:
    """Flip bytes in the middle of ``path`` — the injected torn write."""
    size = os.path.getsize(path)
    if size == 0:
        return
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(min(n, size - size // 2))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
