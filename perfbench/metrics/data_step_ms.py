"""The data step's device time an iteration: the device time of each traced
recon (the union of the intervals of what its span launched) less that of
its denoiser calls, over the iterations."""


def read(ctx):
    if ctx.kind != "recon":
        return None
    calls = ctx.trace.span_busy_s.get("pb.call")
    den = ctx.trace.span_busy_s.get("pb.denoiser")
    if not calls or not den or sum(calls) <= 0:
        return None
    return 1e3 * (sum(calls) - sum(den)) / (len(calls) * ctx.iterations_per_call)
