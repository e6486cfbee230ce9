"""The port's fused KD loss (B8) against the JAX package's, on the CPU.

On the CPU the port's `kd_loss` wrapper runs its plain version; the JAX
package runs its Pallas kernel in interpret mode, as `tests/test_kernels.py`
does. Same shapes and T/alpha sweep as that test; tolerance rel 1e-4,
abs 1e-5 (the kernel's online accumulators sum in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import kd_merge_splits, kd_split_partials, t
from repro.kernels.kd_loss import kd_loss as jkd
from repro.kernels.kd_loss import ops as jkd_ops
from repro.kernels.kd_loss.ref import kd_loss_ref as jkd_loss_ref
from repro_torch.core import distill as tdistill
from repro_torch.kernels.kd_loss import kd_loss as tkd
from repro_torch.kernels.kd_loss import ops as tkd_ops
from repro_torch.kernels.kd_loss.ref import kd_loss_ref as tkd_loss_ref


def _case(seed, b, v, scale=3.0, dims=None):
    rng = np.random.default_rng(seed)
    shape = dims or (b, v)
    zs = (rng.standard_normal(shape) * scale).astype(np.float32)
    zt = (rng.standard_normal(shape) * scale).astype(np.float32)
    y = rng.integers(0, v, shape[:-1]).astype(np.int32)
    return zs, zt, y


@pytest.mark.parametrize("b,v", [(13, 5000), (8, 152064 // 16), (256, 2048),
                                 (3, 17), (64, 504), (128, 10)])
def test_shapes(b, v):
    zs, zt, y = _case(b + v, b, v)
    got = float(tkd_ops.distillation_loss(t(zs), t(zt), t(y)))
    want = float(jkd_ops.distillation_loss(jnp.asarray(zs), jnp.asarray(zt),
                                           jnp.asarray(y)))
    ref = float(jnp.mean(jkd_loss_ref(jnp.asarray(zs), jnp.asarray(zt),
                                      jnp.asarray(y))))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-5)
    assert got == pytest.approx(ref, rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("temperature,alpha", [
    (1.0, 0.0), (1.0, 1.0), (2.0, 0.25), (4.0, 0.5), (6.5, 0.9), (8.0, 0.7)])
def test_hyperparams(temperature, alpha):
    zs, zt, _ = _case(int(temperature * 10 + alpha * 100), 6, 400, 2.0)
    y = np.arange(6, dtype=np.int32) * 7
    got = tkd.kd_loss(t(zs), t(zt), t(y), temperature=temperature,
                      alpha=alpha).numpy()
    want = np.asarray(jkd_loss_ref(jnp.asarray(zs), jnp.asarray(zt),
                                   jnp.asarray(y), temperature=temperature,
                                   alpha=alpha))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    mean = float(jkd_ops.distillation_loss(
        jnp.asarray(zs), jnp.asarray(zt), jnp.asarray(y),
        temperature=temperature, alpha=alpha))
    assert float(tkd_ops.distillation_loss(
        t(zs), t(zt), t(y), temperature=temperature, alpha=alpha)) == \
        pytest.approx(mean, rel=1e-4, abs=1e-5)


def test_sequence_input():
    """(B, S, V) logits with (B, S) labels: rows flattened, then the mean."""
    zs, zt, y = _case(1, 0, 300, dims=(4, 7, 300))
    got = float(tkd_ops.distillation_loss(t(zs), t(zt), t(y),
                                          temperature=2.0, alpha=0.3))
    want = float(jkd_ops.distillation_loss(jnp.asarray(zs), jnp.asarray(zt),
                                           jnp.asarray(y), temperature=2.0,
                                           alpha=0.3))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-5)


def test_out_of_range_label_picks_zero():
    """The TPU kernel picks the label with a one-hot over the columns, so a
    label outside the columns picks 0: its CE is the log-sum-exp alone.
    The TPU kernel pads V up to its vocab tile (2048 here) with -1e30, so a
    label in [V, 2048) picks that padding (a loss near 5e29); the port
    reads no padding and picks 0 for every label outside [0, V)."""
    zs, zt, y = _case(2, 5, 33)
    y[1], y[3] = -1, 4096
    got = tkd.kd_loss(t(zs), t(zt), t(y)).numpy()
    # the JAX kernel row by row (its public entry point takes the mean)
    want = [float(jkd_ops.distillation_loss(
        jnp.asarray(zs[i:i + 1]), jnp.asarray(zt[i:i + 1]),
        jnp.asarray(y[i:i + 1]))) for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    y[4] = 33  # = V
    ce = tkd.kd_loss(t(zs), t(zt), t(y), alpha=0.0).numpy()  # CE alone
    lse = torch.logsumexp(t(zs), dim=-1).numpy()
    np.testing.assert_allclose(ce[[1, 3, 4]], lse[[1, 3, 4]], rtol=1e-6)
    rows = [0, 2]
    np.testing.assert_allclose(ce[rows], lse[rows] - zs[rows, y[rows]],
                               rtol=1e-5)


def test_bf16_logits():
    zs, zt, y = _case(3, 8, 1000)
    zs16, zt16 = (torch.from_numpy(a).to(torch.bfloat16) for a in (zs, zt))
    got = float(tkd_ops.distillation_loss(zs16, zt16, t(y)))
    want = float(jkd_ops.distillation_loss(
        jnp.asarray(zs, jnp.bfloat16), jnp.asarray(zt, jnp.bfloat16),
        jnp.asarray(y)))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-5)
    # the same values in f32: bf16 is only read, then cast
    assert got == pytest.approx(float(tkd_ops.distillation_loss(
        zs16.float(), zt16.float(), t(y))), rel=1e-6)


def test_matches_core_distill_and_ref():
    """The fused loss equals the trainer's Eq. 1 (`core.distill`) and the
    port's own oracle, per sample."""
    zs, zt, _ = _case(4, 32, 100, 1.0)
    y = (np.arange(32) % 100).astype(np.int32)
    got = tkd_ops.distillation_loss(t(zs), t(zt), t(y), temperature=4.0,
                                    alpha=0.5)
    want = tdistill.distillation_loss(t(zs), t(zt), t(y), alpha=0.5,
                                      temperature=4.0)
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    np.testing.assert_allclose(
        tkd.kd_loss(t(zs), t(zt), t(y)).numpy(),
        tkd_loss_ref(t(zs), t(zt), t(y)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tkd_loss_ref(t(zs), t(zt), t(y)).numpy(),
        np.asarray(jkd_loss_ref(jnp.asarray(zs), jnp.asarray(zt),
                                jnp.asarray(y))), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    zs, zt, y = _case(5, 4, 50)
    tkd.reset_launches()
    got = tkd.kd_loss(t(zs), t(zt), t(y), block=(8, 128))
    assert tkd.LAUNCHES["kd_loss"] == 0
    np.testing.assert_array_equal(
        got.numpy(), tkd.kd_loss_plain(t(zs), t(zt), t(y)).numpy())
    assert got.dtype == torch.float32 and got.shape == (4,)


# ---------------------------------------------------------------------------
# The split design of the B8 kernel (`csrc/kd_loss.cu`, split_kernel),
# checked on its plain mirror (`_torch_parity.kd_split_partials` /
# `kd_merge_splits`), not on the kernel, which runs only on the card
# (chip_smoke.py holds it to the plain version there).
# ---------------------------------------------------------------------------

def _jax_rows(zs, zt, y, temperature=4.0, alpha=0.5):
    """The JAX Pallas kernel (interpret mode), per row."""
    return np.asarray(jkd.kd_loss(jnp.asarray(zs), jnp.asarray(zt),
                                  jnp.asarray(y), temperature=temperature,
                                  alpha=alpha, interpret=True))


@pytest.mark.parametrize("splits", [1, 2, 5, 8])
@pytest.mark.parametrize("b,v", [(6, 3001), (3, 5), (4, 40)])
def test_split_mirror_matches_jax(b, v, splits):
    """Runs of `split_cols(V, S)` columns, merged in run order, equal the
    JAX kernel within rel 1e-4; V < S leaves runs empty (the identity)."""
    zs, zt, y = _case(b * v + splits, b, v)
    cols = tkd.split_cols(v, splits)
    assert cols % tkd.SPLIT_ALIGN == 0 and splits * cols >= v
    parts = kd_split_partials(t(zs), t(zt), t(y), splits, cols, 2.0)
    if v < splits:
        empty = parts[:, -1]
        assert bool((empty[:, [0, 3, 5]] == -1e30).all())
        assert bool((empty[:, [1, 2, 4, 6, 7]] == 0).all())
    got = kd_merge_splits(parts, 2.0, 0.3).numpy()
    np.testing.assert_allclose(got, _jax_rows(zs, zt, y, 2.0, 0.3),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_mirror_out_of_range_labels(splits):
    """Labels -1, V and 4096 pick 0 in every run (CE = lse); an in-range
    label is picked by exactly one run. -1 and 4096 are held to the JAX
    kernel, V to the port's plain version (the JAX kernel pads V to its
    2,048-column tile, so a label in [V, 2048) picks its -1e30 padding)."""
    b, v = 5, 2050
    zs, zt, y = _case(40 + splits, b, v)
    y[1], y[2], y[3] = -1, v, 4096
    cols = tkd.split_cols(v, splits)
    parts = kd_split_partials(t(zs), t(zt), t(y), splits, cols, 4.0)
    picked = (parts[:, :, 7] != 0).sum(-1).tolist()
    assert picked == [1, 0, 0, 0, 1]
    got = kd_merge_splits(parts, 4.0, 0.5).numpy()
    want = _jax_rows(zs, zt, y)
    rows = [0, 1, 3, 4]
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, tkd.kd_loss_plain(t(zs), t(zt), t(y)).numpy(), rtol=1e-4,
        atol=1e-5)


def test_split_mirror_bf16():
    zs, zt, y = _case(44, 4, 3000)
    zs16, zt16 = (torch.from_numpy(a).to(torch.bfloat16) for a in (zs, zt))
    got = kd_merge_splits(kd_split_partials(zs16, zt16, t(y), 5,
                                            tkd.split_cols(3000, 5), 4.0),
                          4.0, 0.5).numpy()
    want = _jax_rows(jnp.asarray(zs, jnp.bfloat16),
                     jnp.asarray(zt, jnp.bfloat16), y)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,v", [(64, 32000), (8, 152064), (1, 152064),
                                 (128, 10), (13, 5000), (3, 1025),
                                 (256, 2048), (1, 1), (4096, 2048),
                                 (1024, 152064), (300, 8193)])
def test_split_plan(b, v):
    """S >= 1 runs of L columns (a multiple of 8) cover the row, none starts
    past V, and B x S covers the H100's 132 SMs at the bench shape and the
    Qwen vocabulary."""
    s, cols = tkd.split_plan(b, v)
    assert s >= 1 and cols % tkd.SPLIT_ALIGN == 0
    assert (s - 1) * cols < v <= s * cols
    assert s == 1 or cols >= tkd.MIN_SPLIT_COLS
    if (b, v) in ((64, 32000), (8, 152064)):
        assert b * s >= tkd.H100_SMS
    assert tkd.split_plan(b, v, sms=264)[0] >= s
