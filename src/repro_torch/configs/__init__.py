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

__all__ = ["ConvLayerSpec", "LM_ARCHS", "ModelConfig", "SHAPES", "XRConfig",
           "XR_ARCHS", "cell_is_runnable", "get_config", "get_smoke", "smoke",
           "smoke_xr"]

# Assigned input-shape sets (LM family): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


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


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Assignment skip rules for (arch x shape) dry-run cells."""
    cfg = get_config(arch)
    if not isinstance(cfg, ModelConfig):
        return False, "XR arch: evaluated on the edge-DSE plane, not the LM dry-run"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full/windowed attention (see DESIGN §4)"
    return True, ""
