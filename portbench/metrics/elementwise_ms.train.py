"""Device milliseconds a training step spends in ATen's own kernels
(elementwise, reduction, foreach, copy and index kernels, named
``at::native::...``): BN's arithmetic, the global-norm clip and AdamW's
per-leaf updates, outside cuDNN, cuBLAS and the hand-written kernels."""


def read(ctx):
    if ctx.kind != "train" or ctx.summary is None:
        return None
    us = sum(t for name, t in ctx.summary.ops if "at::native" in name)
    return us / 1e3 / ctx.summary.units
