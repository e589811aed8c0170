"""Architecture registry of the port: ``get_config`` / ``get_smoke``.

The paper's XR workloads and the JAX package's ten LM architectures are
ported, in the reference registry's order. A name the reference does not
know raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (ConvLayerSpec, ModelConfig, XRConfig,
                                      smoke, smoke_xr)

_MODULES: Dict[str, str] = {
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-7b": "deepseek_7b",
    "yi-34b": "yi_34b",
    "llama3.2-1b": "llama3p2_1b",
    "mixtral-8x7b": "mixtral_8x7b",
    "grok-1-314b": "grok1_314b",
    "mamba2-1.3b": "mamba2_1p3b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "whisper-small": "whisper_small",
    "detnet": "detnet",
    "edsnet": "edsnet",
}
LM_ARCHS: List[str] = [k for k in _MODULES if k not in ("detnet", "edsnet")]
XR_ARCHS: List[str] = ["detnet", "edsnet"]

__all__ = ["ConvLayerSpec", "LM_ARCHS", "ModelConfig", "XRConfig", "XR_ARCHS",
           "get_config", "get_smoke", "smoke", "smoke_xr"]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch: no such "
            f"architecture in repro.configs; it has {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> Union[ModelConfig, XRConfig]:
    return _mod(name).CONFIG


def get_smoke(name: str) -> Union[ModelConfig, XRConfig]:
    return _mod(name).SMOKE
