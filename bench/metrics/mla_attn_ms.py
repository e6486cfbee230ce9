"""mla_attn_ms: device milliseconds a batch spends in the MLA prefill
attention kernel (`csrc/mla_prefill.cu`: one launch a layer of
`lm._mla_train_attention` on the card without grad), every kernel whose
name holds `KERNEL`, per batch of the traced stretch. None where none ran
(a program without the kernel, or attention through `chunked_attention`)."""

#: the name the kernel carries in a trace (``mla_prefill_kernel``)
KERNEL = "mla_prefill"


def read(ctx):
    s = ctx.trace.device_s(lambda e: e.cat == "kernel" and KERNEL in e.name)
    return s / ctx.steps * 1e3 if s > 0 else None
