"""The port's §III device models (`repro_torch.core.acam`) against the JAX
package's (`repro.core.acam`), on the CPU.

Windows and queries are numpy from a seed. torch cannot draw JAX's threefry
streams, so the noisy cases hand the JAX-drawn standard-normal fields to the
port's noise step (`noise_factors`, `apply_noise`): the windows agree within
2 ulp (XLA's `exp` against torch's). Given the same programmed arrays, the
hard models (`cell_match`, `matchline_voltage`, `dual_rail_mismatch`,
`sense`, `wta`) are bit-identical for both cells, with invalid rows, NaN
queries and a NaN bound, and tied rows. The smooth surrogate and its
gradients agree within rtol 1e-5 (atol 1e-7), five calibration steps
within rtol 1e-4 (atol 1e-6): sigmoid, log-softmax and their gradients
round differently in the two packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t, to_np
from repro.core import acam as ja
from repro_torch.core import acam as ta

CELLS = ("6T4R", "3T1R")


def _windows(seed, rows=12, cells=100):
    """Real windows in [0.05, 0.95], rows 3 and 4 identical (ties), row 1
    invalid, one NaN upper bound; queries in [-0.2, 1.2] with a NaN."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.05, 0.45, (rows, cells)).astype(np.float32)
    hi = (lo + rng.uniform(0.05, 0.5, (rows, cells))).astype(np.float32)
    lo[4], hi[4] = lo[3], hi[3]
    hi[7, 5] = np.nan
    valid = np.ones(rows, bool)
    valid[1] = False
    q = rng.uniform(-0.2, 1.2, (9, cells)).astype(np.float32)
    q[0, 3] = np.nan
    q[2] = lo[3]  # on the tied rows' lower edges: a full match
    return lo, hi, valid, q


def _both(lo, hi, valid, cfg, key=None):
    """The JAX-programmed array, and the port's array of the same bits."""
    jp = ja.program(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid),
                    ja.ACAMConfig(**cfg), key)
    tp = ta.ProgrammedACAM(t(jp.lower), t(jp.upper), t(jp.valid),
                           ta.ACAMConfig(**jp.config._asdict()))
    return jp, tp


def test_program_at_sigma_zero_bit_identical():
    lo, hi, valid, _ = _windows(0)
    for sigma, key in ((0.0, None), (0.0, jax.random.PRNGKey(1)),
                       (0.2, None)):
        jp = ja.program(jnp.asarray(lo), jnp.asarray(hi),
                        jnp.asarray(valid), ja.ACAMConfig(
                            sigma_program=sigma), key)
        tp = ta.program(lo, hi, valid, ta.ACAMConfig(sigma_program=sigma),
                        None if key is None else 1, device="cpu")
        for name in ("lower", "upper", "valid"):
            np.testing.assert_array_equal(to_np(getattr(tp, name)),
                                          np.asarray(getattr(jp, name)))
        assert tuple(tp.config) == tuple(jp.config)


@pytest.mark.parametrize("sigma", [0.05, 0.3])
def test_noise_step_on_jax_fields_within_2_ulp(sigma):
    """JAX programs ``lo * exp(sigma * z1)``, ``hi * exp(sigma * z2)``,
    ``hi = max(hi, lo)`` with ``z1, z2`` drawn from ``split(key)``; the
    port's noise step, fed those fields, gives the same windows to 2 ulp,
    never inverted."""
    lo, hi, valid, _ = _windows(1)
    hi = np.nan_to_num(hi, nan=0.5)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    z_lo = np.asarray(jax.random.normal(k1, lo.shape))
    z_hi = np.asarray(jax.random.normal(k2, hi.shape))
    jp = ja.program(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid),
                    ja.ACAMConfig(sigma_program=sigma), key)
    got_lo, got_hi = ta.apply_noise(
        t(lo), t(hi), *ta.noise_factors(t(z_lo), t(z_hi), sigma))
    np.testing.assert_array_max_ulp(to_np(got_lo), np.asarray(jp.lower), 2)
    np.testing.assert_array_max_ulp(to_np(got_hi), np.asarray(jp.upper), 2)
    assert bool((got_hi >= got_lo).all())


def test_program_keys_deterministic_distinct_and_optional():
    """The port's own draws: one key programs one array; keys, draws and
    shards differ; a generator acts as a seed drawn from it; no key (or
    sigma 0) programs the ideal windows; windows never invert."""
    lo, hi, valid, _ = _windows(2)
    hi = np.nan_to_num(hi, nan=0.5)
    cfg = ta.ACAMConfig(sigma_program=0.15)

    def prog(key):
        return ta.program(lo, hi, valid, cfg, key, device="cpu")

    base = ta.prng_key(3)
    a, b = prog(3), prog(base)
    assert torch.equal(a.lower, b.lower) and torch.equal(a.upper, b.upper)
    assert not np.array_equal(to_np(a.lower), lo)
    assert bool((a.upper >= a.lower).all())
    others = [prog(4), *map(prog, ta.split(base, 2)), prog(ta.fold_in(base,
                                                                      0))]
    arrays = [a.lower] + [p.lower for p in others]
    for i in range(len(arrays)):
        for j in range(i):
            assert not torch.equal(arrays[i], arrays[j])
    assert ta.split(base, 2) == [(3, 0), (3, 2)]
    assert ta.fold_in(base, 1) == (3, 3)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    first = prog(g1).lower
    assert torch.equal(first, prog(g2).lower)
    assert not torch.equal(first, prog(g1).lower)  # g1 moved on
    np.testing.assert_array_equal(to_np(prog(None).lower), lo)
    ideal = ta.program(lo, hi, valid, ta.ACAMConfig(), 3, device="cpu")
    np.testing.assert_array_equal(to_np(ideal.upper), hi)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("sigma", [0.0, 0.1])
def test_hard_models_bit_identical(cell, sigma):
    lo, hi, valid, q = _windows(3)
    jp, tp = _both(lo, hi, valid, dict(cell=cell, sigma_program=sigma),
                   jax.random.PRNGKey(5))
    jq, tq = jnp.asarray(q), t(q)
    np.testing.assert_array_equal(to_np(ta.cell_match(tp, tq)),
                                  np.asarray(ja.cell_match(jp, jq)))
    np.testing.assert_array_equal(to_np(ta.matchline_voltage(tp, tq)),
                                  np.asarray(ja.matchline_voltage(jp, jq)))
    for g, w in zip(ta.dual_rail_mismatch(tp, tq),
                    ja.dual_rail_mismatch(jp, jq)):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    s_t, s_j = ta.sense(tp, tq), ja.sense(jp, jq)
    np.testing.assert_array_equal(to_np(s_t), np.asarray(s_j))
    assert np.isneginf(to_np(s_t)[:, 1]).all()
    w_t = ta.wta(s_t)
    np.testing.assert_array_equal(to_np(w_t), np.asarray(ja.wta(s_j)))
    assert w_t.dtype == torch.int32 and int(w_t[2]) == 3  # tie: lowest row
    np.testing.assert_array_equal(
        to_np(ta.classify_rows_to_classes(w_t, 2)),
        np.asarray(ja.classify_rows_to_classes(ja.wta(s_j), 2)))


def test_unknown_cell_raises():
    lo, hi, valid, q = _windows(4)
    _, tp = _both(lo, hi, valid, dict(cell="2T2R"))
    with pytest.raises(ValueError, match="unknown cell"):
        ta.sense(tp, t(q))


def test_soft_sense_and_gradients_within_rtol():
    lo, hi, valid, q = _windows(5)
    hi = np.nan_to_num(hi, nan=0.5)
    q = np.nan_to_num(q, nan=0.3)
    jp, tp = _both(lo, hi, valid, dict(cell="3T1R"))
    np.testing.assert_allclose(to_np(ta.soft_sense(tp, t(q))),
                               np.asarray(ja.soft_sense(jp, jnp.asarray(q))),
                               rtol=1e-5, atol=1e-7)
    labels = np.arange(9) % 12

    def jloss(bounds):
        sim = ja.soft_sense(jp._replace(lower=bounds[0], upper=bounds[1]),
                            jnp.asarray(q))
        logp = jax.nn.log_softmax(sim * 10.0, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=-1))

    jg = jax.grad(jloss)((jp.lower, jp.upper))
    lo_v = tp.lower.clone().requires_grad_(True)
    hi_v = tp.upper.clone().requires_grad_(True)
    loss = ta.calibration_loss(tp._replace(lower=lo_v, upper=hi_v), t(q),
                               torch.as_tensor(labels))
    np.testing.assert_allclose(loss.item(), float(jloss((jp.lower,
                                                         jp.upper))),
                               rtol=1e-5)
    tg = torch.autograd.grad(loss, (lo_v, hi_v))
    for g, w in zip(tg, jg):
        assert np.abs(np.asarray(w)).max() > 0
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_calibrate_windows_five_steps_within_rtol():
    rng = np.random.default_rng(6)
    lo = rng.uniform(0.05, 0.45, (4, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.05, 0.5, (4, 16))).astype(np.float32)
    valid = np.ones(4, bool)
    feats = rng.uniform(0.0, 1.0, (32, 16)).astype(np.float32)
    labels = np.arange(32) % 4
    jp, tp = _both(lo, hi, valid, dict(cell="3T1R"))
    jc = ja.calibrate_windows(jp, jnp.asarray(feats), jnp.asarray(labels),
                              steps=5, lr=0.05)
    with torch.no_grad():  # calibration takes its own gradients
        tc = ta.calibrate_windows(tp, t(feats), torch.as_tensor(labels),
                                  steps=5, lr=0.05)
    for name in ("lower", "upper"):
        np.testing.assert_allclose(to_np(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)),
                                   rtol=1e-4, atol=1e-6)
    assert bool((tc.upper >= tc.lower).all())
    before = ta.calibration_loss(tp, t(feats), torch.as_tensor(labels))
    after = ta.calibration_loss(tc, t(feats), torch.as_tensor(labels))
    assert float(after) < float(before)


@pytest.mark.parametrize("batch", [1, 37])
def test_search_energy_equal(batch):
    lo, hi, valid, _ = _windows(7)
    jp, tp = _both(lo, hi, valid, {})
    assert float(ta.search_energy(tp, batch)) == \
        float(ja.search_energy(jp, batch))
