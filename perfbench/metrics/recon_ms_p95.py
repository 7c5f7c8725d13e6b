"""The 95th percentile of every recon's time in the window, from the call
to its synchronized ``x_hat``, each timed by CUDA events the benchmark
records in the stream around the call (the device's clock: the card is
idle when a call starts, so the first event is stamped as it is queued)."""


def read(ctx):
    if ctx.kind != "recon" or not ctx.latencies_ms:
        return None
    return ctx.percentile(ctx.latencies_ms, 0.95)
