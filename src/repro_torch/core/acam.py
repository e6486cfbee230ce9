"""RRAM-CMOS TXL-ACAM device/behaviour models (paper §III).

The paper employs the Template piXeL (TXL) ACAM in two cell flavours:

  - 6T4R charging cell (Fig. 4a): on a match the cell charges the row
    matchline through a current-limiter pMOS; a capacitor integrates the
    per-row charge and a sense amplifier thresholds the time-to-charge.
  - 3T1R precharging cell (Fig. 4b): complementary nMOS/pMOS pairs discharge
    dual matchlines ML_LOW / ML_HIGH when the input is below / above the
    window; evaluating both separately makes the cell *differentiable*.

A behavioural simulator at the level the program-once-read-many flow needs:
window programming with log-normal RRAM write noise, matchline charge (6T4R)
or dual-rail discharge counts (3T1R), sense-amplifier outputs, and a smooth
(sigmoid-windowed) surrogate for gradient calibration of the windows. Plain
PyTorch on whichever device holds the operands: the JAX package computes
none of this in a Pallas kernel.

Programming keys
----------------
The JAX package draws the write noise from threefry keys: ``PRNGKey(seed)``,
``split(key, M)`` for Monte-Carlo draws and ``fold_in(key, s)`` for the
array of bank shard s. torch cannot reproduce those streams, so a key here
is the path of that derivation, a tuple of ints:

  prng_key(seed)     -> (seed,)
  split(key, M)[m]   -> key + (2 m,)
  fold_in(key, s)    -> key + (2 s + 1,)

A key seeds a CPU `torch.Generator` through numpy's `SeedSequence` (entropy
the seed, spawn key the rest of the path), so distinct paths draw
independent streams. `program` also takes an int (a seed) or a
`torch.Generator`, which contributes one integer drawn from it as the seed.
The two standard-normal fields (lower edges first, then upper, as JAX's
``k1, k2 = split(key)``) are drawn on the CPU and ``exp(sigma * z)`` is taken
there too, then moved to the array's device and cached per (key, shape,
sigma, device): the same key programs the same bits on the card and on the
CPU. Like a JAX key, the field depends only on the key and the shape.

Every scalar divisor is a device tensor: on CUDA, division by a Python
scalar becomes a product with its reciprocal, one ulp off the quotient.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve


class ACAMConfig(NamedTuple):
    cell: str = "6T4R"  # or "3T1R"
    vdd: float = 1.8  # 180 nm CMOS supply
    # matchline dynamics
    c_ml: float = 20e-15  # matchline capacitance [F]
    i_cell: float = 2e-6  # per-cell current-limited charge current [A]
    t_eval: float = 10e-9  # evaluation window [s]
    sense_frac: float = 0.5  # sense-amp threshold as fraction of VDD
    # RRAM programming
    sigma_program: float = 0.0  # log-normal sigma on window edges
    #: calibrate I_cell so a full-row match charges exactly to VDD within
    #: t_eval (§III-B)
    auto_calibrate: bool = True
    # energy
    e_cell: float = 185e-15  # J per similarity-search op per cell (§III-B)
    # differentiable surrogate sharpness
    beta: float = 25.0


class ProgrammedACAM(NamedTuple):
    """ACAM array with windows programmed into (noisy) RRAM conductances.

    lower/upper: (rows, cells) programmed window bounds; valid: (rows,).
    """

    lower: torch.Tensor
    upper: torch.Tensor
    valid: torch.Tensor
    config: ACAMConfig


# ---------------------------------------------------------------------------
# programming keys and write noise
# ---------------------------------------------------------------------------

def prng_key(seed: int) -> tuple[int, ...]:
    """The key of a seed (JAX: ``PRNGKey(seed)``)."""
    return (int(seed),)


def split(key, num: int) -> list[tuple[int, ...]]:
    """``num`` per-draw keys of one key (JAX: ``split(key, num)``)."""
    base = as_key(key)
    return [base + (2 * m,) for m in range(num)]


def fold_in(key, data: int) -> tuple[int, ...]:
    """The key of bank shard ``data`` (JAX: ``fold_in(key, data)``)."""
    return as_key(key) + (2 * int(data) + 1,)


def as_key(key) -> tuple[int, ...]:
    """An int (a seed), a key path or a `torch.Generator` -> a key path."""
    if isinstance(key, torch.Generator):
        return (int(torch.randint(0, 2**62, (1,), generator=key,
                                  device=key.device)),)
    if isinstance(key, (int, np.integer)):
        return prng_key(key)
    return tuple(int(k) for k in key)


def normal_fields(key, shape) -> tuple[torch.Tensor, torch.Tensor]:
    """The key's two standard-normal (lower, upper) fields, on the CPU."""
    path = as_key(key)
    seq = np.random.SeedSequence(entropy=path[0] % 2**64,
                                 spawn_key=path[1:])
    gen = torch.Generator().manual_seed(
        int(seq.generate_state(1, np.uint64)[0]))
    return (torch.randn(shape, generator=gen),
            torch.randn(shape, generator=gen))


def noise_factors(z_lo: torch.Tensor, z_hi: torch.Tensor, sigma: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-normal edge factors ``exp(sigma * z)``, computed where z lies."""
    return torch.exp(sigma * z_lo), torch.exp(sigma * z_hi)


def apply_noise(lower: torch.Tensor, upper: torch.Tensor,
                f_lo: torch.Tensor, f_hi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale each window edge by its factor; windows cannot invert
    (``torch.maximum`` keeps a NaN, as ``jnp.maximum`` does)."""
    lo = lower * f_lo
    return lo, torch.maximum(upper * f_hi, lo)


@functools.lru_cache(maxsize=64)
def _factors(path: tuple[int, ...], shape: tuple[int, ...], sigma: float,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    f_lo, f_hi = noise_factors(*normal_fields(path, shape), sigma)
    return f_lo.to(device), f_hi.to(device)


def program(lower, upper, valid, config: ACAMConfig, key=None, *,
            device=None) -> ProgrammedACAM:
    """Program windows on ``device`` (the card unless the caller asks for
    the CPU); apply RRAM variability if ``sigma_program > 0`` and a key is
    given (no key: the ideal array, as in the JAX package).

    Models the write-time log-normal spread of RRAM conductance, which
    shifts the hybrid-inverter thresholds, i.e. the realised window edges.
    """
    dev = resolve(device)
    lo = torch.as_tensor(lower, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(upper, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if config.sigma_program > 0.0 and key is not None:
        lo, hi = apply_noise(lo, hi, *_factors(
            as_key(key), tuple(lo.shape), float(config.sigma_program), dev))
    if config.auto_calibrate:
        n_cells = lo.shape[-1]
        i_cal = config.c_ml * config.vdd / (config.t_eval * n_cells)
        config = config._replace(i_cell=i_cal)
    return ProgrammedACAM(lo, hi, valid, config)


# ---------------------------------------------------------------------------
# matchline dynamics and sensing
# ---------------------------------------------------------------------------

def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _count(cmp) -> torch.Tensor:
    """Per-row count of a (B, rows, cells) bool array as f32: the integer
    sum the JAX package's f32 sum of 0/1 values gives exactly."""
    return cmp.sum(dim=-1).to(torch.float32)


def _in_window(acam: ProgrammedACAM, queries: torch.Tensor) -> torch.Tensor:
    q = queries[:, None, :]
    m = q >= acam.lower[None]
    m &= q <= acam.upper[None]
    return m


def cell_match(acam: ProgrammedACAM, queries: torch.Tensor) -> torch.Tensor:
    """Hard per-cell match: (B, rows, cells) in {0, 1} (f32).

    6T4R: match <=> input inside window (cell charges ML). 3T1R: match <=>
    neither ML_LOW nor ML_HIGH discharges; a NaN input matches neither.
    """
    return _in_window(acam, queries).to(torch.float32)


def matchline_voltage(acam: ProgrammedACAM, queries: torch.Tensor
                      ) -> torch.Tensor:
    """6T4R matchline voltage after t_eval: (B, rows).

    n matching cells charge C_ml in parallel through current limiters:
        V(t) = min(VDD, n * I_cell * t_eval / C_ml)
    """
    cfg = acam.config
    n_match = _count(_in_window(acam, queries))
    v = (n_match * _scalar(cfg.i_cell, queries)
         * _scalar(cfg.t_eval, queries) / _scalar(cfg.c_ml, queries))
    return torch.minimum(v, _scalar(cfg.vdd, queries))


def dual_rail_mismatch(acam: ProgrammedACAM, queries: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """3T1R: per-row counts of low-side and high-side mismatches (B, rows)."""
    q = queries[:, None, :]
    return _count(q < acam.lower[None]), _count(q > acam.upper[None])


def sense(acam: ProgrammedACAM, queries: torch.Tensor) -> torch.Tensor:
    """Sense-amplifier output per template row (B, rows).

    6T4R: normalised matchline voltage (fraction of VDD at readout).
    3T1R: fraction of cells whose dual rails both stayed high.
    Invalid rows are driven to -inf so the WTA never selects them.
    """
    cfg = acam.config
    if cfg.cell == "6T4R":
        s = matchline_voltage(acam, queries) / _scalar(cfg.vdd, queries)
    elif cfg.cell == "3T1R":
        low, high = dual_rail_mismatch(acam, queries)
        n = acam.lower.shape[-1]
        s = 1.0 - (low + high) / _scalar(float(n), queries)
    else:
        raise ValueError(f"unknown cell {cfg.cell}")
    return torch.where(acam.valid[None, :], s, _scalar(float("-inf"), s))


def sense_compiled(acam: ProgrammedACAM, queries: torch.Tensor
                   ) -> torch.Tensor:
    """`sense` in the arithmetic the JAX package's jitted serve tick runs.

    The optimised HLO of that tick (`jax.jit(...).lower(...).compile()` of
    the scheduler's `_batched_classify`, device backend, 6T4R and 3T1R at
    N 64 and 784) folds the chain into constants computed in f32:

      6T4R  min(n * K, vdd) * R,  K = (i_cell * t_eval) * (1 / c_ml),
            R = 1 / vdd;  K = 0.028125 at N 64, 0.0022959183 at N 784
      3T1R  1 - (low + high) * R,  R = 1 / N, with the multiply and the
            subtract contracted into one FMA (a single rounding)

    The FMA is taken in float64: the counts are integers and R an f32, so
    the product and the difference are exact there (N < 2**30) and the
    cast to f32 is the FMA's one rounding. The engine's un-jitted calls
    keep `sense`, the JAX engine's op-by-op order.
    """
    cfg = acam.config
    f32 = np.float32
    if cfg.cell == "6T4R":
        k = f32(f32(f32(cfg.i_cell) * f32(cfg.t_eval))
                * f32(f32(1) / f32(cfg.c_ml)))
        vdd = f32(cfg.vdd)
        n_match = _count(_in_window(acam, queries))
        v = torch.minimum(n_match * _scalar(k, queries),
                          _scalar(vdd, queries))
        s = v * _scalar(f32(1) / vdd, queries)
    elif cfg.cell == "3T1R":
        low, high = dual_rail_mismatch(acam, queries)
        r = float(f32(1) / f32(acam.lower.shape[-1]))
        s = (1.0 - (low + high).to(torch.float64) * r).to(torch.float32)
    else:
        raise ValueError(f"unknown cell {cfg.cell}")
    return torch.where(acam.valid[None, :], s, _scalar(float("-inf"), s))


def soft_sense(acam: ProgrammedACAM, queries: torch.Tensor) -> torch.Tensor:
    """Differentiable surrogate of `sense` (3T1R differentiability, §III):
    each cell's match indicator becomes the product of two sigmoids around
    the window edges, so gradients flow to lower/upper. Invalid rows -1e9.
    """
    cfg = acam.config
    q = queries[:, None, :]
    m = torch.sigmoid(cfg.beta * (q - acam.lower[None])) * torch.sigmoid(
        cfg.beta * (acam.upper[None] - q))
    s = m.mean(dim=-1)
    return torch.where(acam.valid[None, :], s, _scalar(-1e9, s))


def wta(similarities: torch.Tensor) -> torch.Tensor:
    """Winner-take-all row index (B,) int32, the lowest index on ties."""
    return torch.argmax(similarities, dim=-1).to(torch.int32)


def classify_rows_to_classes(row_winner: torch.Tensor, rows_per_class: int
                             ) -> torch.Tensor:
    """Map winning template row -> class id (rows laid out class-major)."""
    return row_winner // rows_per_class


def search_energy(acam: ProgrammedACAM, batch: int = 1) -> torch.Tensor:
    """Energy per batch of similarity searches: rows x cells x E_cell x B
    (Eq. 14 over the valid rows; never-programmed rows are power-gated)."""
    cfg = acam.config
    cells = acam.lower.shape[-1]
    rows = acam.valid.to(torch.int32).sum()
    return rows * cells * cfg.e_cell * batch


# ---------------------------------------------------------------------------
# gradient calibration of the windows (program once, after this)
# ---------------------------------------------------------------------------

def calibration_loss(acam: ProgrammedACAM, features: torch.Tensor,
                     labels_rows: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the known rows under `soft_sense` row scores."""
    sim = soft_sense(acam, features)
    logp = torch.log_softmax(sim * 10.0, dim=-1)
    return -logp.gather(-1, labels_rows.long()[:, None]).mean()


def calibrate_windows(acam: ProgrammedACAM, features: torch.Tensor,
                      labels_rows: torch.Tensor, *, steps: int = 100,
                      lr: float = 0.05) -> ProgrammedACAM:
    """Gradient calibration of windows against known row assignments; the
    final windows are what gets programmed once to hardware. Each step
    takes both gradients at the same windows, then ``lo -= lr * g_lo; hi
    -= lr * g_hi; hi = max(hi, lo)``."""
    lo, hi = acam.lower.detach(), acam.upper.detach()
    with torch.enable_grad():
        for _ in range(steps):
            lo_v = lo.requires_grad_(True)
            hi_v = hi.requires_grad_(True)
            loss = calibration_loss(acam._replace(lower=lo_v, upper=hi_v),
                                    features, labels_rows)
            g_lo, g_hi = torch.autograd.grad(loss, (lo_v, hi_v))
            lo = (lo_v - lr * g_lo).detach()
            hi = torch.maximum((hi_v - lr * g_hi).detach(), lo)
    return acam._replace(lower=lo, upper=hi)
