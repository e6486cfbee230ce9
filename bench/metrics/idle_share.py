"""idle_share: the share of the traced stretch, in %, in which no kernel,
copy or memset ran on the card."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return (1 - ctx.trace.busy_s() / ctx.trace.window_s) * 100
