"""The process's surroundings: compiler caches inside the checkout, one
host thread for the CPU libraries, and the modules that must never be
loaded."""
from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_process_env(root: Path) -> None:
    """Every compiler and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA kernels into ``build/torch_kernels``), and
    one thread for OpenMP, MKL and OpenBLAS: the cells' host work is one
    Python thread, and idle pool threads of eight took set-up time and
    throughput from it on the card's shared host (PERF.md, section 2).
    Call before torch or numpy is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_compute_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
