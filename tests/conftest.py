import os
import sys

# Tests run on the single host CPU device (the multi-device dry-run tests
# spawn subprocesses that set XLA_FLAGS before importing jax) — unless
# REPRO_FORCE_MESH=DxM asks for a forced-CPU mesh, in which case the whole
# tier-1 suite executes under the engine's 2D PartitionPlan (batch over
# "data", bank class rows over "model"); results are bit-identical, so the
# suite doubles as the sharded-execution regression net.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.distributed import forcemesh  # noqa: E402  (imports no jax)

# phase 1 must precede any jax backend init — conftest imports before tests
_FORCED = forcemesh.apply_xla_flags()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (multi-minute) integration tests")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (the port's kernels); skipped "
        "without one")
    if _FORCED:
        forcemesh.install()
