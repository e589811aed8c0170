"""The whole training step's share of the card's float32 peak: model
FLOPs (3 x 2 x MACs an image, counted from the benchmark's own layer
plan) of every image trained in the window over the window's host-clock
time, in percent. The nets run float32 with TF32 off, so the peak is the
float32 rate outside the tensor cores."""


def read(ctx):
    if ctx.kind != "train" or not ctx.peaks or ctx.seconds <= 0:
        return None
    flops = ctx.counts["flops_per_item"] * ctx.items
    return 100.0 * flops / ctx.seconds / ctx.peaks["f32_flops"]
