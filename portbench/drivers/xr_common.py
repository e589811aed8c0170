"""What the two XR drivers share: the program's configuration object made
from the benchmark's configuration file, the precision flags, the wait
for the device."""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from portbench.counts import xr as counts


def program_config(cfg: Mapping):
    """The port's ``XRConfig`` holding the file's sizes."""
    from repro_torch.configs.base import XRConfig
    names = {f.name for f in dataclasses.fields(XRConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    for k in ("input_hw", "decoder_channels"):
        kw[k] = tuple(kw[k])
    kw["stages"] = tuple(tuple(s) for s in kw["stages"])
    return XRConfig(**kw)


def set_tf32(on: bool) -> None:
    """float32 as the configuration states it: TF32 off for cuDNN's
    convolutions and for matmuls (``on`` only for the control)."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def work_counts(cfg: Mapping, batch: int, kind: str) -> dict:
    fwd, wgrad = counts.dw_launches_per_unit(cfg, kind)
    return {"flops_per_item": counts.model_flops(cfg, kind),
            "dw_bytes_per_unit": counts.dw_bytes_per_unit(cfg, batch, kind),
            "dw_launches_per_unit": fwd, "dw_wgrad_launches_per_unit": wgrad}
