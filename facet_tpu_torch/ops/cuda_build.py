"""Build and load the port's CUDA kernels.

Every ``facet_tpu_torch/csrc/*.cu`` file (with the ``*.cuh`` headers they
include) is compiled at first use by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c``, all of them started together, and the objects are linked into
one shared library with a plain C interface under ``build/kernels/``
(listed in ``.gitignore``), named by a hash of the sources and flags, and
loaded with ctypes. Nothing is built when the module is imported: the CPU
tests import every module and have no nvcc.

The library links no ``libcuda``: the attention kernels' TMA tensor maps
are encoded by libcuda's ``cuTensorMapEncodeTiled``, which
``csrc/hopper.cuh`` looks up at run time through the CUDA runtime's
``cudaGetDriverEntryPointByVersion``, so the build needs CUDA 12.5 or later.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_longlong)
# C entry point -> argument types (pointers and the stream are c_void_p)
SIGNATURES = {
    "facet_hs_entropy": [_P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    "facet_hs_workspace": [_I, _I, _LP],
    "facet_cross_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "facet_gray_stats": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    "facet_fused_stats": [_P, _P, _P, _P, _P, _I, _L, _I, _P],
    "facet_fused_stats_scratch": [_I, _LP],
    "facet_row_softmax": [_P, _P, _L, _I, _P],
    "facet_vit_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "facet_cross_attention_geometry": [_I, _I, _I, _IP, _IP, _LP, _LP],
    "facet_vit_attention_geometry": [_I, _I, _I, _IP, _IP, _LP],
}

_lib = None
build_info = {}    # seconds, ptxas log and library path of the last build


def _nvcc():
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC to its path)")


def build():
    """Compile csrc/*.cu into one .so (cached by content) -> its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libfacet_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, log="(cached)", path=str(lib_path))
        return lib_path
    work = BUILD_DIR / f"objects.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    jobs = [(src, subprocess.Popen(
        [nvcc, *FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for src in sources]
    done = [(src, job, *job.communicate()) for src, job in jobs]    # wait for all
    log = []
    for src, job, out, err in done:
        log.append(err + out)
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({job.returncode}):\n{out}\n{err}")
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(work / f"{src.stem}.o") for src in sources]],
                          capture_output=True, text=True)
    shutil.rmtree(work, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=time.time() - t0, log="".join(log), path=str(lib_path))
    return lib_path


def library():
    """The loaded kernel library (built on first call). ctypes looks each
    entry point up once, on its first use, and keeps it on the library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# The wrappers' host path, per launch. A wrapper runs once per ViT layer or
# per batch, so these keep to what a launch needs.
_sm_counts = {}     # device index -> SM count, asked once


def on_device(device):
    """The context to launch on ``device`` in: none when it is already the
    current device (the common case, and the cheap one), else
    ``torch.cuda.device(device)``."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device):
    """The raw cudaStream_t (an int) of the current stream on ``device``,
    from torch's own C binding: ``torch.cuda.current_stream(device)`` builds
    a Stream object inside a device context on every call, which cost more
    than the rest of a launch (chip_smoke.py prints each wrapper's host
    path)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def sm_count(device):
    """The SM count of the card ``device``, asked once per process."""
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]


def check(err, name):
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
