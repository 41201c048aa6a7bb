"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

(plus ``EXTRA_FLAGS[name]``, where a library has any).

The library lands in ``kernels/build/lib<name>.so`` at first use (rebuilt
when the source is newer). Every C entry takes its pointers and PyTorch's
current stream as ``void*`` and returns ``cudaGetLastError()`` after its
launch; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Flags of one library on top of NVCC_FLAGS. The f64 decisions of K10 and
# K12 (and their first designs'), and K11's sums, feed margin flags or sums
# that must equal their plain versions', and so do the f32 decisions of
# K14 and K15 and K16's f64 coefficient and flag: no multiply-add
# contraction.
EXTRA_FLAGS = {"preemphasis": ("-fmad=false",),
               "lpc_analyze_f32": ("-fmad=false",),
               "rice_cost": ("-fmad=false",),
               "ltp_analyze": ("-fmad=false",),
               "ltp_analyze_v1": ("-fmad=false",),
               "svr_cov": ("-fmad=false",),
               "svr_refine": ("-fmad=false",),
               "svr_refine_v1": ("-fmad=false",)}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc per library in this process (0.0: already built).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if there is no up-to-date ``build/lib<name>.so``."""
    return load_all([name])[name]


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Load several kernels' libraries; the ones that need building are
    compiled by concurrent nvcc processes, one per source."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = {}
        for name in names:
            if name in _LIBS:
                continue
            src = os.path.join(SRC_DIR, f"{name}.cu")
            so = os.path.join(BUILD_DIR, f"lib{name}.so")
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                jobs[name] = (src, so, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
                     tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
        failed = []
        for name, (src, so, tmp, proc) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{err}")
            else:
                os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _LIBS:
                build_seconds.setdefault(name, 0.0)
                _LIBS[name] = ctypes.CDLL(
                    os.path.join(BUILD_DIR, f"lib{name}.so"))
        return {name: _LIBS[name] for name in names}


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_arg(what: str, name: str, t, shape: tuple, device) -> None:
    """Raise unless t is a contiguous int32 tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust nothing else."""
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: {name} must be a contiguous int32 tensor "
                         f"of shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
