"""Images reconstructed per second: every image of every recon completed in
the window, over the window's length (host clock)."""


def read(ctx):
    if ctx.kind != "recon":
        return None
    return ctx.images_per_call * ctx.calls / ctx.window_s
