"""Share of the traced INT8 requests in which no operation ran on the card
(one less the union of the device operations' intervals over the traced
window), in percent: the host's part of a request, the batch's copy to
the card among it."""


def read(ctx):
    if ctx.kind != "infer" or ctx.summary is None:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_us / ctx.summary.window_us)
