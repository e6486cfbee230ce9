"""mfu.lm: a language-model batch's share of the card's dense bf16 peak
(989.4 TFLOP/s on the tensor cores, the precision the configuration
states), in %: the model operations of every sequence of the traced
stretch as the ``lm_classify`` traffic kind counts them
(`flops_per_sequence`: MLA projections and causal attention, the dense
MLPs, the router and the shared expert), plus `routed_flops_per_row` for
each row the held experts computed there (the program's counter, in the
window's host totals as ``traced_held_rows``), over the stretch's
length."""

from bench.harness import cells


def read(ctx):
    rows = ctx.host.get("traced_held_rows")
    if not ctx.trace.device or rows is None:
        return None
    kind = cells.load_module("traffic", ctx.traffic["kind"])
    flops = (ctx.items * kind.flops_per_sequence(ctx.config,
                                                 ctx.traffic["seq_len"])
             + rows * kind.routed_flops_per_row(ctx.config))
    return flops / ctx.trace.window_s / kind.BF16_FLOPS * 100
