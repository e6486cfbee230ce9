"""Shared helpers of the PyTorch-port parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy. The port runs on the CPU (``device="cpu"``), where each
kernel wrapper runs its plain PyTorch version; the JAX package runs its
Pallas kernels in interpret mode, as its own tests do.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import textwrap

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


def binary_windows(rng: np.random.Generator, c: int, k: int, n: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(lower, upper) (C, K, N) windows as `generate_templates` builds them
    for the deployed binary setting: lower in {0, 1}, upper = max(upper,
    lower) in {0, 1}."""
    lower = (rng.random((c, k, n)) > 0.5).astype(np.float32)
    upper = np.maximum((rng.random((c, k, n)) > 0.5).astype(np.float32),
                       lower)
    return lower, upper


def dyadic_windows(rng: np.random.Generator, c: int, k: int, n: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(lower, upper) (C, K, N) real windows of quarter steps, lower <=
    upper: Eq. 9's distance is exact in any summation order."""
    lower = dyadic(rng, (c, k, n), -8, 1)
    return lower, lower + dyadic(rng, (c, k, n), 0, 9)


def assert_equal_outputs(got, want, names=("pred", "per_class", "margin",
                                           "escalate")) -> None:
    """Bit-identical outputs, element by element (inf == inf)."""
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(to_np(g), to_np(w), err_msg=name)


# ---------------------------------------------------------------------------
# Sharded execution: forced meshes in the port, the JAX package's sharded
# path in a subprocess (its host-device count is fixed when jax starts)
# ---------------------------------------------------------------------------

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@contextlib.contextmanager
def port_mesh(shape: tuple[int, int]):
    """A forced (data, model) mesh of the CPU repeated, installed in the
    port's context for the ``with`` block and cleared after (the mesh is a
    process global: a later test in this worker must not run sharded)."""
    from repro_torch.distributed import context, forcemesh

    try:
        yield forcemesh.install(shape, device="cpu")
    finally:
        context.clear()


class JaxJob:
    """``code`` running in a fresh interpreter whose jax has ``ndev`` CPU
    host devices (``env`` adds variables); the code prints one JSON
    object on a line starting "OUT ". Started at construction, so the
    port's side of a test can run meanwhile; `result` waits. One job per
    scenario group: each costs a jax start-up."""

    def __init__(self, code: str, ndev: int, env: dict | None = None):
        full = dict(os.environ)
        full["PYTHONPATH"] = SRC
        full["JAX_PLATFORMS"] = "cpu"
        full["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
        full.pop("REPRO_FORCE_MESH", None)
        full.pop("REPRO_REDUCE_STRATEGY", None)
        full.update(env or {})
        self._proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=full)
        self._out = None

    def result(self, timeout: int = 600) -> dict:
        if self._out is None:
            try:
                stdout, stderr = self._proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.communicate()
                raise
            assert self._proc.returncode == 0, f"stderr:\n{stderr[-3000:]}"
            lines = [li for li in stdout.splitlines()
                     if li.startswith("OUT ")]
            assert lines, f"no OUT line:\n{stdout[-2000:]}"
            self._out = json.loads(lines[-1][4:])
        return self._out


def run_jax_sharded(code: str, ndev: int, env: dict | None = None,
                    timeout: int = 600) -> dict:
    """`JaxJob` run to its end."""
    return JaxJob(code, ndev, env).result(timeout)


# ---------------------------------------------------------------------------
# A plain mirror of the similarity kernels' bit-packed arithmetic
# (csrc/acam_tiled.cuh, the kSimilarity scorer)
# ---------------------------------------------------------------------------

def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(R, N) bools -> (R, ceil(N / 32)) int32 words: bit j of word w is
    feature 32 w + j, the bits past N zero (as `__ballot_sync` packs)."""
    r, n = bits.shape
    w = -(-n // 32)
    padded = torch.zeros((r, w * 32), dtype=torch.int64)
    padded[:, :n] = bits.to(torch.int64)
    words = (padded.view(r, w, 32) << torch.arange(32)).sum(-1)
    return (words - (words >> 31 << 32)).to(torch.int32)  # two's complement


def popc(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as `__popc` counts them), int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    return ((x[..., None] >> torch.arange(32)) & 1).sum(-1)


def window_planes(lower: torch.Tensor, upper: torch.Tensor):
    """Window rows (M, N) -> (h0, h1, binary): the planes h0 = (lo <= 0 <=
    hi) and h1 = (lo <= 1 <= hi) as packed words, and each row's flag that
    every lo and hi is exactly 0 or 1 (-0 counts as 0, a NaN does not)."""
    def is_bit(x):
        return (x == 0) | (x == 1)

    h0 = pack_words((lower <= 0) & (upper >= 0))
    h1 = pack_words((lower <= 1) & (upper >= 1))
    return h0, h1, (is_bit(lower) & is_bit(upper)).all(dim=-1)


def packed_hits(q: torch.Tensor, h0: torch.Tensor,
                h1: torch.Tensor) -> torch.Tensor:
    """(B, M) Eq. 10 hit counts of binary queries (B, N) against packed
    window planes: sum_w popc(~q_w & h0_w) + popc(q_w & h1_w). ``~q`` is
    1 past N, so the count is exact only because h0 is 0 there."""
    qw = pack_words(q.to(torch.bool))[:, None, :]
    return (popc(~qw & h0[None]) + popc(qw & h1[None])).sum(-1)


# ---------------------------------------------------------------------------
# A plain mirror of the kd_loss kernel's split design (csrc/kd_loss.cu,
# split_kernel): each row's columns in runs, one partial per run, the
# partials merged in run order
# ---------------------------------------------------------------------------

KD_NEG = -1e30  # the identity's running maxima, as in the kernel


def kd_split_partials(zs: torch.Tensor, zt: torch.Tensor,
                      labels: torch.Tensor, splits: int, cols: int,
                      temperature: float) -> torch.Tensor:
    """(B, splits, 8) f32 partials (m_u, l_u, a, m_v, l_v, m_w, l_w, pick)
    of runs [s cols, s cols + cols) of the (B, V) logits (clipped at V; an
    empty run is the identity: maxima -1e30, sums 0). A run's maxima start
    at -1e30; pick is z_s[label] for the one run holding the label."""
    zs, zt = zs.to(torch.float32), zt.to(torch.float32)
    b, v = zs.shape
    inv_t = torch.tensor(1.0, dtype=torch.float32) / temperature
    neg = torch.full((b,), KD_NEG, dtype=torch.float32)
    rows = torch.arange(b)
    lab = labels.long()
    parts = []
    for s in range(splits):
        c0, c1 = min(s * cols, v), min(s * cols + cols, v)
        u, w = zt[:, c0:c1] * inv_t, zs[:, c0:c1]
        vv = w * inv_t
        mu, mv, mw = (torch.maximum(neg, x.amax(-1)) if c1 > c0 else neg
                      for x in (u, vv, w))
        eu = torch.exp(u - mu[:, None])
        inside = (lab >= c0) & (lab < c1)
        pick = torch.where(inside, zs[rows, lab.clamp(0, v - 1)],
                           torch.zeros(()))
        parts.append(torch.stack([
            mu, eu.sum(-1), (eu * (u - vv)).sum(-1),
            mv, torch.exp(vv - mv[:, None]).sum(-1),
            mw, torch.exp(w - mw[:, None]).sum(-1), pick], dim=-1))
    return torch.stack(parts, dim=1)


def kd_merge_splits(parts: torch.Tensor, temperature: float,
                    alpha: float) -> torch.Tensor:
    """Per-row Eq. 1 (B,) from `kd_split_partials`, merged in run order by
    the rescale rule, then the kernel's epilogue."""
    p = parts[:, 0].unbind(-1)
    mu, lu, a, mv, lv, mw, lw, pick = p
    for s in range(1, parts.shape[1]):
        q = parts[:, s].unbind(-1)
        mn = torch.maximum(mu, q[0])
        s1, s2 = torch.exp(mu - mn), torch.exp(q[0] - mn)
        lu, a, mu = lu * s1 + q[1] * s2, a * s1 + q[2] * s2, mn
        mn = torch.maximum(mv, q[3])
        lv, mv = lv * torch.exp(mv - mn) + q[4] * torch.exp(q[3] - mn), mn
        mn = torch.maximum(mw, q[5])
        lw, mw = lw * torch.exp(mw - mn) + q[6] * torch.exp(q[5] - mn), mn
        pick = pick + q[7]
    kl = a / lu - (mu + torch.log(lu)) + (mv + torch.log(lv))
    ce = (mw + torch.log(lw)) - pick
    return (alpha * temperature**2) * kl + (1.0 - alpha) * ce
