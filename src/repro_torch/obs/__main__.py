"""`python -m repro_torch.obs <events.jsonl> [metrics.prom]` — the CI
telemetry-smoke validator (same CLI as `repro_torch.obs.export`, without
runpy's found-in-sys.modules warning)."""
import sys

from .export import _main

if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
