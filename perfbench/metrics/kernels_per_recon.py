"""Device kernels launched per recon, counted in the trace."""


def read(ctx):
    if ctx.kind != "recon" or ctx.trace.kernels == 0:
        return None
    return ctx.trace.kernels / ctx.calls
