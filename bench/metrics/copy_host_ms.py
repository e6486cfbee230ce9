"""copy_host_ms: host milliseconds a batch or step spends handing its
inputs to the card, per batch or step of the traced stretch: every
``repro_torch.*.to_device`` span (`HybridClassifier.predict`'s frames,
`cnn_trainer.to_device`'s images, labels and teacher logits), which holds
the blocking copy and, for pageable memory, the wait on the card's work
queued before it."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda name: name.endswith(".to_device"))
