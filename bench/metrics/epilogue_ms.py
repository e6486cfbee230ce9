"""epilogue_ms: device milliseconds a batch spends in the student's fused
convolution epilogues (`csrc/student_epilogue.cu`: bias, ReLU, eval
BatchNorm and the 2x2 max-pool after conv1 and conv2; bias and ReLU after
conv3 and conv4), every kernel whose name holds `KERNEL`, per batch of the
traced stretch. None where none ran (a program without the kernel)."""

#: the name the epilogue kernels share in a trace
#: (``student_epilogue_pool_kernel``, ``student_epilogue_relu_kernel``)
KERNEL = "student_epilogue"


def read(ctx):
    s = ctx.trace.device_s(lambda e: e.cat == "kernel" and KERNEL in e.name)
    return s / ctx.steps * 1e3 if s > 0 else None
