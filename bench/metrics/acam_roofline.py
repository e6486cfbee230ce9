"""acam_roofline: the ACAM classify kernel's (B1, ``tiled_kernel`` in
`csrc/acam_match.cu`) share of its roofline, in %: the least time of a
call at the cell's shape (`roofline.acam_match_classify_bound`: batch x
classes x templates a class x features) over its mean device time a call
in the traced stretch."""

from bench.harness import roofline


def read(ctx):
    calls = [e for e in ctx.trace.device
             if e.cat == "kernel" and roofline.ACAM_KERNEL in e.name]
    if not calls:
        return None
    cfg = ctx.config
    bound_ms, _, _ = roofline.acam_match_classify_bound(
        ctx.traffic["batch"], cfg["num_classes"], cfg["templates_per_class"],
        cfg["num_features"])
    per_call_ms = sum(e.end - e.start for e in calls) / len(calls) / 1e3
    return bound_ms / per_call_ms * 100
