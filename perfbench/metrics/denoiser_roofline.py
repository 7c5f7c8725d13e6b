"""The denoiser's share of its roofline: the least time of a denoiser call
(the larger of its conv operations over the bf16 peak and its weight, input
and output bytes, each once, over the memory bandwidth) over the device
time of the operations launched inside the benchmark's span around the call
(the union of their intervals), over every call traced. It reads the same
work whatever implements the network."""

from perfbench import harness


def read(ctx):
    spans = ctx.trace.span_busy_s.get("pb.denoiser") if ctx.kind == "recon" else None
    if not spans or ctx.peak is None or sum(spans) <= 0:
        return None
    least = harness.load_module("counts/convs.py").bound_s(
        ctx.denoiser_flops, ctx.denoiser_bytes, ctx.peak)
    return 100.0 * least * len(spans) / sum(spans)
