"""The port's depthwise kernels in a training step against their memory
bound, in percent: the least bytes of every launch (the forward and the
input gradient by ``dw3x3_kernel``, the weight gradient by
``dw3x3_wgrad_kernel``; shapes from the benchmark's own plan, each input
byte read once and each output byte written once) at the card's HBM rate,
over the kernels' summed device time in the traced steps. Nothing is read
where the trace does not hold exactly the launches the plan predicts."""


def read(ctx):
    if ctx.kind != "train" or ctx.summary is None or not ctx.peaks:
        return None
    fwd = [t for n, t in ctx.summary.ops if "dw3x3_kernel" in n]
    wgrad = [t for n, t in ctx.summary.ops if "dw3x3_wgrad_kernel" in n]
    units = ctx.summary.units
    if (len(fwd) != units * ctx.counts["dw_launches_per_unit"]
            or len(wgrad) != units * ctx.counts["dw_wgrad_launches_per_unit"]):
        return None
    bound_s = units * ctx.counts["dw_bytes_per_unit"] / ctx.peaks["hbm_bytes"]
    return 100.0 * bound_s / ((sum(fwd) + sum(wgrad)) / 1e6)
