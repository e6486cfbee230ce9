"""conv_ms: device milliseconds a step spends in convolutions (forward,
data gradient and weight gradient), per step of the traced stretch: every
device operation launched from inside an ATen convolution operator
(``aten::cudnn_convolution``, ``aten::convolution_backward`` ...),
whatever the kernel cuDNN chose (implicit GEMM, FFT with its cuBLAS
complex products, Winograd, layout transposes)."""


def read(ctx):
    s = ctx.trace.device_s(lambda e: "convolution" in e.launch)
    return s / ctx.steps * 1e3 if s > 0 else None
