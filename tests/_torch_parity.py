"""Shared helpers of the PyTorch-port parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy. The port runs on the CPU (``device="cpu"``), where each
kernel wrapper runs its plain PyTorch version; the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.
"""
from __future__ import annotations

import numpy as np
import torch

# The suite runs under several pytest-xdist workers on one host; torch's
# default of one intra-op thread per core in every worker would contend
# with the timing-sensitive tests running beside it.
torch.set_num_threads(1)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x) -> torch.Tensor:
    """numpy -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def dyadic(rng: np.random.Generator, shape, lo: int = -8, hi: int = 9,
           denom: float = 4.0) -> np.ndarray:
    """Exactly representable f32 values n/denom: sums in any order agree, and
    nothing lands in the subnormal range (the JAX CPU backend reads a
    subnormal operand as zero, torch does not)."""
    return (rng.integers(lo, hi, size=shape) / denom).astype(np.float32)


def binary_bank(rng: np.random.Generator, c: int, k: int, n: int,
                p_valid: float = 0.8) -> dict:
    """A (C, K, N) {0,1} template bank as numpy: the kernels' precondition
    (templates are binary) is asserted here, where every test bank is made."""
    templates = (rng.random((c, k, n)) > 0.5).astype(np.float32)
    assert set(np.unique(templates)) <= {0.0, 1.0}
    return dict(templates=templates, valid=rng.random((c, k)) < p_valid)


def assert_equal_outputs(got, want, names=("pred", "per_class", "margin",
                                           "escalate")) -> None:
    """Bit-identical outputs, element by element (inf == inf)."""
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(to_np(g), to_np(w), err_msg=name)
