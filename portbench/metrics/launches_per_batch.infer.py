"""Device operations (kernels, copies, fills) an INT8 request puts on the
card, counted in the traced requests: the batch's copy, the per-call
weight fake-quant (``quantize_params``) and the eval-mode forward, whose
activations stay float32 (no ``act_scales``)."""


def read(ctx):
    if ctx.kind != "infer" or ctx.summary is None:
        return None
    return len(ctx.summary.ops) / ctx.summary.units
