"""One place for the port's device rule: the card unless asked for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no usable card. Nothing falls back to the CPU: a caller that wants the
    plain PyTorch path passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; repro_torch entry points "
            "run on the card by default. Pass device='cpu' to run the plain "
            "PyTorch path.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
