"""The port's HuBERT ACAM-head example
(`repro_torch.examples.acam_head_for_hubert`) against the JAX package's
`generate_templates` and `ACAMHead`, on the CPU, at SMOKE size: the same
features (the port's encoder's logits, upcast to f32) give the same bank,
predictions, accuracy and energy per frame, bit for bit."""
import functools

import jax.numpy as jnp
import numpy as np
from _torch_parity import to_np  # noqa: F401  (one torch thread per worker)

from repro.core import hybrid as jhybrid
from repro.core import templates as jtemplates
from repro_torch.examples import acam_head_for_hubert


@functools.lru_cache(maxsize=None)
def _hubert():
    return acam_head_for_hubert.main([], device="cpu")


def test_hubert_example_head_is_the_jax_head():
    """The port's example at SMOKE: its ACAM accuracy and nJ per frame are
    what JAX's `generate_templates` and `ACAMHead` give on the same
    features (the port's own, upcast to f32)."""
    r = _hubert()
    assert r["layers"] == 2 and r["vocab"] == 64 and r["n_classes"] == 16
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]
    assert r["features"].shape == (16 * 32, 64)
    cal = jnp.asarray(r["cal_features"].numpy())
    bank = jtemplates.generate_templates(
        cal, jnp.asarray(r["cal_labels"].numpy()), 16, k=1)
    head = jhybrid.ACAMHead(bank=bank)
    pred, per_class = head(jnp.asarray(r["features"].numpy()))
    y = jnp.asarray(r["labels"].numpy())
    np.testing.assert_array_equal(r["pred"].numpy(), np.asarray(pred))
    np.testing.assert_array_equal(r["per_class"].numpy(),
                                  np.asarray(per_class))
    assert r["acc_acam"] == float(jnp.mean(pred == y))
    assert r["nj_per_frame"] == head.energy_per_inference() * 1e9
    assert r["acc_dense"] == float(jnp.mean(
        jnp.argmax(jnp.asarray(r["features"].numpy()), -1) == y))
