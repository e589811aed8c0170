"""Architecture registry of the port: ``get_config`` / ``get_smoke``.

Only the paper's XR workloads are ported so far; the LM architectures of
``repro.configs`` wait for the LM slice.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ConvLayerSpec, XRConfig, smoke_xr

XR_ARCHS = ["detnet", "edsnet"]

__all__ = ["ConvLayerSpec", "XRConfig", "XR_ARCHS", "get_config",
           "get_smoke", "smoke_xr"]


def _mod(name: str):
    if name not in XR_ARCHS:
        raise KeyError(
            f"arch {name!r} is not in repro_torch; it has {XR_ARCHS}. The LM "
            "architectures of repro.configs are not ported yet.")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> XRConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> XRConfig:
    return _mod(name).SMOKE
