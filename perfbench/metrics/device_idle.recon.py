"""The share of a recon's wall time in which no operation runs on the card:
100 (1 - busy / wall), busy a traced recon's device time (the union of the
device operations' intervals), wall the time a recon takes untraced at the
cell's load (the untraced calls of the traced run: the profiler slows the
host's issue, so the traced calls' own wall time would read its cost)."""


def read(ctx):
    if ctx.kind != "recon" or ctx.trace.busy_s <= 0 or ctx.untraced_calls == 0:
        return None
    busy = ctx.trace.busy_s / ctx.calls
    return 100.0 * (1.0 - busy / (ctx.untraced_s / ctx.untraced_calls))
