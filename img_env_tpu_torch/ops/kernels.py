"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``img_env_tpu_torch/csrc/*.cu`` with a plain C
interface.  ``library()`` compiles them with nvcc for ``sm_90a`` at first
use — one nvcc process per source, all started together, then one link
into a shared library under ``img_env_tpu_torch/_build/<hash>/``, keyed by
a hash of the sources and flags — and loads it with ctypes.
Nothing is built or loaded when the package is imported: CPU tensors never
reach a kernel (each wrapper runs its plain-torch twin for them).

Every C entry point returns ``cudaGetLastError()``; ``launch`` raises if it
is not 0, so a refused launch (too many threads, too much shared memory)
surfaces at the call.  ``LAUNCHES`` counts kernel launches per kernel name;
a wrapper bumps its count only where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("raster.cu", "fill.cu", "paint.cu", "pedmap.cu", "paint_block.cu",
           "edt.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# name -> (C symbol, argtypes); every symbol returns int (cudaError_t)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "raster": ("img_env_raster_robots",
               (_P, _P, _I, _I, _I, _I, _I, _P, _P)),
    "fill": ("img_env_fill_sorted",
             (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P,
              _P, _P, _P)),
    "paint": ("img_env_paint_slots", (_P, _P, _I, _I, _P, _P, _P, _I, _P)),
    "pedmap": ("img_env_ped_map",
               (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P)),
    "paint_block": ("img_env_paint_blocks",
                    (_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _P, _I, _P)),
    "edt": ("img_env_edt", (_P, _I, _I, _I, _I, _F, _P)),
}

LAUNCHES = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with nvcc's output if any
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = os.path.join(BUILD_ROOT, _source_hash())
        so = os.path.join(out_dir, "libimg_env_kernels.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tag = f"{os.getpid()}.tmp"
            objs = [os.path.join(out_dir, f"{src}.{tag}.o")
                    for src in SOURCES]
            _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                       os.path.join(CSRC, src)]
                      for src, obj in zip(SOURCES, objs)])
            tmp = f"{so}.{tag}"
            _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, so)
            for obj in objs:
                os.remove(obj)
        lib = ctypes.CDLL(so)
        for sym, argtypes in _SIGNATURES.values():
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point on the current stream (appended
    as the last argument) and count the launch."""
    sym, _ = _SIGNATURES[name]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), sym)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel inputs must all be CUDA tensors")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
