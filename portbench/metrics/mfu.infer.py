"""The whole INT8 evaluation's share of the card's float32 peak: model
FLOPs (2 x MACs an image) of every image evaluated in the window over the
window's host-clock time, in percent. The fake-quantized net computes in
float32 with TF32 off."""


def read(ctx):
    if ctx.kind != "infer" or not ctx.peaks or ctx.seconds <= 0:
        return None
    flops = ctx.counts["flops_per_item"] * ctx.items
    return 100.0 * flops / ctx.seconds / ctx.peaks["f32_flops"]
