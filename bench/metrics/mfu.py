"""mfu: the whole batch's or step's share of the card's float32 peak (67
TFLOP/s outside the tensor cores, the precision the configurations state),
in %: the operations of one image as the cell's traffic kind counts them
(its ``flops_per_item``: the front end's forward for classification; the
forward, weight gradients and input gradients but the first
convolution's for a training step) for every image of the traced
stretch, over the stretch's length."""

from bench.harness import roofline


def read(ctx):
    if not ctx.trace.device or not ctx.flops_per_item:
        return None
    flops = ctx.flops_per_item * ctx.items
    return flops / ctx.trace.window_s / roofline.FP32_FLOPS * 100
