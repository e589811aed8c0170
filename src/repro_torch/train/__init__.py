"""Training of the port: optimizers, gradient compression, checkpoints and
the XR training loop (counterpart of ``repro.train``; LM training waits for
the next slice)."""
from repro_torch.train import checkpoint, compress, loop, optim

__all__ = ["checkpoint", "compress", "loop", "optim"]
