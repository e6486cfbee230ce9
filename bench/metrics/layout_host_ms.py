"""layout_host_ms: host milliseconds a batch spends re-laying the
class-major template bank into the kernel's layout (`kernels/acam_match/
ops.py` and `kernels/acam_similarity/ops.py`), the
``repro_torch.acam.layout`` span, per batch of the traced stretch: 0.0
where the program records spans but no re-layout (a cached layout)."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.acam.layout")
