"""grad_host_ms: host milliseconds a training step spends in its
``value_and_grad`` call (forward, loss and backward enqueued), the
``repro_torch.train.grad`` span, per step of the traced stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.train.grad")
