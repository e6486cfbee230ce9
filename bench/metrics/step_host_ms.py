"""step_host_ms: host milliseconds a call of the trainer's step takes
(`cnn_trainer._make_step`'s step with `to_device`: the batch's copy, the
forward and backward enqueued, clip, AdamW and the masks), the window's
total over its calls: a mean over the whole window."""


def read(ctx):
    if not ctx.host.get("calls"):
        return None
    return ctx.host["call_s"] / ctx.host["calls"] * 1e3
