"""match_host_ms: host milliseconds a batch spends in the matching
engine's classify (`MatchEngine._classify_via`: the backend and plan, the
kernel wrapper with its bank re-layout and launch, any cross-shard
reduce), the ``repro_torch.match.classify`` span, per batch of the traced
stretch."""

from bench.harness import spans


def read(ctx):
    return spans.host_ms(ctx, lambda n: n == "repro_torch.match.classify")
