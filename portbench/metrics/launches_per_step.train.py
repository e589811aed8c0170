"""Device operations (kernels, copies, fills) a training step puts on the
card, counted in the traced steps: the step's launch count, which fusing
the optimizer's per-leaf updates or the BN arithmetic lowers."""


def read(ctx):
    if ctx.kind != "train" or ctx.summary is None:
        return None
    return len(ctx.summary.ops) / ctx.summary.units
