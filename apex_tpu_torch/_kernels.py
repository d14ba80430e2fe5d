"""Builder and loader of the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with :mod:`ctypes`.
The build happens at first use, into ``build/apex_tpu_torch/`` at the root
of the checkout; the library's file name carries a hash of the sources and
flags, so an edited source is rebuilt.  Each source compiles in its own
``nvcc`` process, all started together, then one ``nvcc`` links them.  A
failed build raises with ``nvcc``'s output.

Every C entry point returns ``cudaGetLastError()`` after its launch and
:func:`check` raises when it is not 0: a refused launch never runs, and
``torch.cuda.synchronize()`` would not report it.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("layer_norm_fwd.cu", "layer_norm_bwd.cu", "flash_fwd.cu",
           "flash_bwd_dq.cu", "flash_bwd_dkv.cu", "flash_decode.cu",
           "multi_tensor_adam.cu", "multi_tensor_scale.cu",
           "multi_tensor_l2norm.cu", "multi_tensor_lamb.cu",
           "multi_tensor_axpby.cu", "multi_tensor_sgd.cu",
           "multi_tensor_adagrad.cu", "multi_tensor_novograd.cu",
           "lm_head_fwd.cu",
           "lm_head_bwd.cu", "ffn_fwd.cu", "ffn_bwd.cu",
           "flash_decode_paged.cu", "quant_gemm.cu")
HEADERS = ("common.cuh", "multi_tensor.cuh", "multi_tensor_list.cuh",
           "mma.cuh", "ffn.cuh", "gemm.cuh", "decode.cuh")
BUILD_DIR = _PKG.parent / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# kernel dtype codes (csrc/common.cuh `DType`)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint32
# scale, causal, then dropout (on, threshold, keep scale, seed), dtype, stream
_FLASH_TAIL = [_F, _I, _I, _U, _F, _U, _I, _P]
_SIGNATURES = {
    "apex_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _I, _P],
    "apex_layer_norm_bwd": [_P] * 9 + [_L, _I, _I, _I, _I, _I, _I, _P],
    "apex_flash_fwd": [_P] * 6 + [_I] * 5 + [_L] * 12 + _FLASH_TAIL,
    "apex_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_L] * 15 + _FLASH_TAIL,
    "apex_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_L] * 18 + _FLASH_TAIL,
    "apex_flash_decode": [_P] * 6 + [_I] * 5 + [_L] * 10 + [_F, _I, _P],
    "apex_multi_tensor_adam": [_I] + [_P] * 9 + [_I, _P, _P],
    "apex_multi_tensor_scale": [_I] + [_P] * 9,
    "apex_multi_tensor_l2norm": [_I] + [_P] * 9,
    "apex_multi_tensor_lamb_stage1": [_I] + [_P] * 10 + [_I, _P, _P, _P, _P],
    "apex_multi_tensor_lamb_stage2": [_I] + [_P] * 10 + [_I, _P, _P],
    "apex_multi_tensor_axpby": [_I] + [_P] * 11,
    "apex_multi_tensor_sgd": [_I] + [_P] * 10 + [_I] * 4 + [_P, _P],
    "apex_multi_tensor_adagrad": [_I] + [_P] * 10 + [_I, _P, _P],
    "apex_multi_tensor_novograd": [_I] + [_P] * 11 + [_I, _P, _P],
    "apex_lm_head_fwd_tiles": [_P, _P, _I, _I, _I],
    "apex_lm_head_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "apex_lm_head_bwd": [_P] * 9 + [_I] * 7 + [_P],
    "apex_ffn_fwd": [_P] * 8 + [_I] * 5 + [_P],
    "apex_ffn_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "apex_flash_decode_paged": [_P] * 7 + [_I] * 7 + [_L] * 10
                               + [_F, _I, _P],
    "apex_quant_gemm": [_P] * 5 + [_I] * 3 + [_L] + [_I] * 4 + [_P],
    "apex_quant_gemm_slots": [_I] * 3,
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of apex_tpu_torch are built at first use and need "
            "the CUDA toolkit")
    return path


def source_hash() -> str:
    """sha256 over the kernel sources, headers and compile flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libapex_tpu_torch_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path.  ``<library>.log`` keeps nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills per kernel)."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        obj = tmp / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
               "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for name, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"== {name}\n{out}{err}")
        if proc.returncode:
            failed.append(f"nvcc failed on {name} (exit {proc.returncode}):"
                          f"\n{err}{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / so.name),
         *(str(obj) for _, obj, _ in jobs)],
        capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{link.stderr}{link.stdout}")
    (tmp / so.name).replace(so)
    so.with_suffix(".log").write_text("\n".join(log))
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.apex_cuda_error_string.argtypes = [ctypes.c_int]
            loaded.apex_cuda_error_string.restype = ctypes.c_char_p
            _lib = loaded
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().apex_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{kernel}: dtype {t.dtype} is not supported "
                        f"(float32, bfloat16, float16)") from None


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index`` (kernels split work by
    it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream() -> int:
    """Handle of PyTorch's current CUDA stream (kernels launch on it)."""
    return torch.cuda.current_stream().cuda_stream
