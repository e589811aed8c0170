"""Training of the port: optimizers, gradient compression, checkpoints, the
XR training loop and the LM step (counterpart of ``repro.train``; the LM
loop is ``launch.train``'s, as in the reference)."""
from repro_torch.train import checkpoint, compress, loop, optim

__all__ = ["checkpoint", "compress", "loop", "optim"]
