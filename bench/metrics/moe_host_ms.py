"""moe_host_ms: host milliseconds a batch spends in a language model's MoE
layers (`layers.moe`: the router, the dispatch with its wait for the
expert counts on the host, the held experts and the shared one), summed
over the layers: the ``repro_torch.lm.moe.*`` spans, per batch of the
traced stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n.startswith("repro_torch.lm.moe."))
