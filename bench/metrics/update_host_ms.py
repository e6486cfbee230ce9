"""update_host_ms: host milliseconds a training step spends after its
gradient (gradient masks, clip, AdamW, parameter masks, the copy into the
model), the ``repro_torch.train.update`` span, per step of the traced
stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.train.update")
