"""Share of the traced training steps in which no operation ran on the
card (one less the union of the device operations' intervals over the
traced window), in percent: how far the host holds the card back."""


def read(ctx):
    if ctx.kind != "train" or ctx.summary is None:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_us / ctx.summary.window_us)
