"""dispatch_host_ms: host milliseconds a batch spends in the MoE layers'
dispatch (`layers.moe`: the sort of the routed slots by expert, the
load-balance statistic and the copy of the expert counts to the host,
which waits for the card to reach it), summed over the layers: the
``repro_torch.lm.moe.dispatch`` spans, per batch of the traced
stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx,
                         lambda n: n == "repro_torch.lm.moe.dispatch")
