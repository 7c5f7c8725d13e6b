"""The whole recon's share of the card's bf16 peak: the network's conv
operations (counted from shapes, ``counts/``) of a recon's denoiser calls,
over the wall time a recon takes untraced at the cell's load (the untraced
calls of the traced run, which the profiler does not slow), over the
peak."""


def read(ctx):
    if ctx.kind != "recon" or ctx.peak is None or ctx.untraced_calls == 0:
        return None
    ops = ctx.untraced_calls * ctx.denoiser_calls_per_call * ctx.denoiser_flops
    return 100.0 * ops / ctx.untraced_s / ctx.peak["bf16_flops_per_s"]
