"""The port's depthwise kernel (``dw3x3_kernel``, forward) in an INT8
request against its memory bound, in percent: the least bytes of its 13
launches (shapes from the benchmark's own plan) at the card's HBM rate,
over their summed device time in the traced requests. Nothing is read
where the trace does not hold exactly the launches the plan predicts."""


def read(ctx):
    if ctx.kind != "infer" or ctx.summary is None or not ctx.peaks:
        return None
    fwd = [t for n, t in ctx.summary.ops if "dw3x3_kernel" in n]
    if len(fwd) != ctx.summary.units * ctx.counts["dw_launches_per_unit"]:
        return None
    bound_s = (ctx.summary.units * ctx.counts["dw_bytes_per_unit"]
               / ctx.peaks["hbm_bytes"])
    return 100.0 * bound_s / (sum(fwd) / 1e6)
