"""frontend_ms: device milliseconds a batch spends in the front end
(`models/cnn.py`): every kernel of the traced stretch but the ACAM
classify kernel (B1, ``tiled_kernel``), the copies and the memsets, per
batch."""

from bench.harness import roofline


def read(ctx):
    s = ctx.trace.device_s(lambda e: e.cat == "kernel"
                           and roofline.ACAM_KERNEL not in e.name)
    return s / ctx.steps * 1e3 if s > 0 else None
