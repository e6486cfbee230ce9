"""frontend_host_ms: host milliseconds a batch spends in the front end's
call (`HybridClassifier.predict`'s ``feature_fn``: the convolutions,
BatchNorm, ReLU and pools enqueued), the ``repro_torch.predict.frontend``
span, per batch of the traced stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.predict.frontend")
