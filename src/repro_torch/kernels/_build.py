"""Build the CUDA kernels at first use and load them with ctypes.

Counterpart of ``repro.kernels._compat`` with no interpret knob: a CUDA
tensor runs the kernel, a CPU tensor its plain version (``kernels.ops``).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared library
with a plain C interface, ``build/torch_kernels/<name>-<hash>.so`` under the
checkout (the hash covers the sources and flags, so an edit rebuilds). All
missing libraries are compiled at once, one ``nvcc`` process each, started
together. The sources include no PyTorch header, which keeps a build at
seconds; the wrappers pass ``data_ptr()`` pointers and the current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("depthwise_conv", "int8_matmul", "quantize", "flash_attention",
           "ssd_scan")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}     # name -> nvcc/ptxas output of this process


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}; the CUDA kernels of "
                           "repro_torch are built on the machine with the card")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, all in
    parallel; returns the seconds it took. Raises on any compiler error."""
    todo = [n for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {p.returncode}:\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_launch(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (the launch never ran)."""
    if code != 0:
        msg = library(name).repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
