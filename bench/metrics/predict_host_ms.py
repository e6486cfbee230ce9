"""predict_host_ms: host milliseconds a call of
`HybridClassifier.predict` takes (entry, engine and kernel wrappers, and
the frames' blocking copy to the card), the window's total over its calls:
a mean over the whole window, not a per-call reading."""


def read(ctx):
    if not ctx.host.get("calls"):
        return None
    return ctx.host["call_s"] / ctx.host["calls"] * 1e3
