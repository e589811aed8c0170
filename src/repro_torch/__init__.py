"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package keeps its module
layout and names so each module's counterpart is easy to find. It imports
torch and numpy, never jax and never ``repro``. Public entry points take
``device=`` and default to ``"cuda"``: without a card they raise unless the
caller asked for ``device="cpu"``, which runs the plain PyTorch versions of
the kernels (the CPU tests do that).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
