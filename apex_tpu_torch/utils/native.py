"""ctypes loader for the port's native host runtime
(``apex_tpu_torch/csrc/host_runtime.cpp``) — port of
``apex_tpu/utils/native.py``.

The library is a plain C-ABI shared object that packs many buffers into one
(:func:`pack` / :func:`unpack`) and streams a buffer to and from a file with
several threads (:func:`file_write` / :func:`file_read`), each call with the
GIL released (:func:`read_into` reads a range of a file, so a reader can
hand chunks to a hasher while it reads on): the host side of
:class:`~apex_tpu_torch.resilience.checkpoint.CheckpointManager`.  It is
built with ``g++`` at first use into
``build/apex_tpu_torch/`` at the root of the checkout (the file name carries
a hash of the source, so an edited source is rebuilt; the build goes to a
temporary name and is renamed into place, so processes that build at once
never load half a file).

It is host code, not a device kernel: where it cannot be built (no ``g++``)
or ``APEX_TPU_NO_NATIVE`` is set, every function takes its numpy path,
which gives the same bytes.  :func:`lib` returns None then, and
:func:`library_path` says which library was loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host_runtime.cpp"
BUILD_DIR = _PKG.parent / "build" / "apex_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_path: Optional[str] = None
_tried = False


def _configure(lib) -> bool:
    try:
        lib.apex_version.restype = ctypes.c_int
        if lib.apex_version() != 1:
            return False
        lib.apex_pack.restype = ctypes.c_int
        lib.apex_pack.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_size_t),
                                  ctypes.c_int, ctypes.c_void_p]
        lib.apex_unpack.restype = ctypes.c_int
        lib.apex_unpack.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t),
                                    ctypes.c_int]
        lib.apex_file_write.restype = ctypes.c_int
        lib.apex_file_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.c_int]
        lib.apex_file_read.restype = ctypes.c_int
        lib.apex_file_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_size_t, ctypes.c_int]
        lib.apex_file_read_at.restype = ctypes.c_int
        lib.apex_file_read_at.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                          ctypes.c_size_t,
                                          ctypes.c_longlong, ctypes.c_int]
        return True
    except AttributeError:
        return False


def _built_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libapex_host_runtime_{digest}.so"


def _compile(target: Path) -> bool:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """The loaded native library, or None (the numpy path)."""
    global _lib, _path, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("APEX_TPU_NO_NATIVE") or not SOURCE.exists():
            return None
        target = _built_path()
        if not target.exists() and not _compile(target):
            return None
        try:
            loaded = ctypes.CDLL(str(target))
        except OSError:
            return None
        if _configure(loaded):
            _lib, _path = loaded, str(target)
        return _lib


def library_path() -> Optional[str]:
    """The file of the loaded library (None on the numpy path)."""
    lib()
    return _path


def _as_1d_bytes(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(-1)


def pack(arrays, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather a list of numpy arrays into one contiguous uint8 buffer
    (natively with every host core; else one slice assignment each)."""
    views = [_as_1d_bytes(a) for a in arrays]
    total = int(sum(v.size for v in views))
    if out is None:
        out = np.empty((total,), np.uint8)
    elif out.dtype != np.uint8 or out.size != total:
        raise ValueError(f"pack: out must be {total} uint8 bytes")
    L = lib()
    if L is None:
        off = 0
        for v in views:
            out[off:off + v.size] = v
            off += v.size
        return out
    n = len(views)
    srcs = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
    sizes = (ctypes.c_size_t * n)(*[v.size for v in views])
    rc = L.apex_pack(srcs, sizes, n, out.ctypes.data)
    if rc != 0:
        raise OSError(-rc, f"apex_pack failed: {rc}")
    return out


def unpack(buf: np.ndarray, arrays) -> None:
    """Scatter a contiguous uint8 buffer back into the given arrays (each
    must be contiguous: the bytes land in the caller's memory)."""
    views = [_as_1d_bytes(a) for a in arrays]
    for a, v in zip(arrays, views):
        if a.__array_interface__["data"][0] != \
                v.__array_interface__["data"][0]:
            raise ValueError("unpack needs contiguous destination arrays")
    buf = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    L = lib()
    if L is None:
        off = 0
        for v in views:
            v[:] = buf[off:off + v.size]
            off += v.size
        return
    n = len(views)
    dsts = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
    sizes = (ctypes.c_size_t * n)(*[v.size for v in views])
    rc = L.apex_unpack(buf.ctypes.data, dsts, sizes, n)
    if rc != 0:
        raise OSError(-rc, f"apex_unpack failed: {rc}")


def file_write(path: str, buf: np.ndarray, threads: int = 4) -> None:
    """Write a contiguous buffer to ``path`` (parallel pwrite natively)."""
    v = _as_1d_bytes(buf)
    L = lib()
    if L is None:
        with open(path, "wb") as f:
            f.write(memoryview(v))
        return
    rc = L.apex_file_write(str(path).encode(), v.ctypes.data, v.size,
                           int(threads))
    if rc != 0:
        raise OSError(-rc, f"apex_file_write({path}) failed")


def file_read(path: str, nbytes: Optional[int] = None,
              threads: int = 4) -> np.ndarray:
    """Read ``path`` into a fresh uint8 buffer (parallel pread natively)."""
    size = os.path.getsize(path) if nbytes is None else int(nbytes)
    out = np.empty((size,), np.uint8)
    read_into(path, out, 0, threads)
    return out


def read_into(path: str, out: np.ndarray, offset: int = 0,
              threads: int = 4) -> None:
    """Fill the contiguous uint8 buffer ``out`` from ``path`` at byte
    ``offset`` (parallel pread natively); raises on a short read."""
    size = int(out.size)
    L = lib()
    if L is None:
        with open(path, "rb") as f:
            f.seek(offset)
            got = f.readinto(memoryview(out))
        if got != size:
            raise OSError(f"{path}: read {got} of {size} bytes")
        return
    rc = L.apex_file_read_at(str(path).encode(), out.ctypes.data, size,
                             int(offset), int(threads))
    if rc != 0:
        raise OSError(-rc, f"apex_file_read_at({path}) failed")
