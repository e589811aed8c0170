"""Architecture registry of the port: ``get_config`` / ``get_smoke``.

The paper's XR workloads and two of the JAX package's LM architectures are
ported; every other name of ``repro.configs`` raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (ConvLayerSpec, ModelConfig, XRConfig,
                                      smoke, smoke_xr)

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "llama3p2_1b",
    "mamba2-1.3b": "mamba2_1p3b",
    "detnet": "detnet",
    "edsnet": "edsnet",
}
LM_ARCHS: List[str] = ["llama3.2-1b", "mamba2-1.3b"]
XR_ARCHS: List[str] = ["detnet", "edsnet"]

__all__ = ["ConvLayerSpec", "LM_ARCHS", "ModelConfig", "XRConfig", "XR_ARCHS",
           "get_config", "get_smoke", "smoke", "smoke_xr"]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch; it has "
            f"{sorted(_MODULES)}. The other architectures of repro.configs "
            "wait for the port's later slices (ROADMAP.md).")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> Union[ModelConfig, XRConfig]:
    return _mod(name).CONFIG


def get_smoke(name: str) -> Union[ModelConfig, XRConfig]:
    return _mod(name).SMOKE
