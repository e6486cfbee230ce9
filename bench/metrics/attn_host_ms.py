"""attn_host_ms: host milliseconds a batch spends in a language model's
attention (`lm._layer_full`'s MLA or attention: projections, rotation,
`chunked_attention`, the output projection, enqueued), summed over the
layers: the ``repro_torch.lm.attn`` spans, per batch of the traced
stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.lm.attn")
