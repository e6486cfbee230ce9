"""The port's checkpointer against the JAX package's, in both directions.

A step written by `repro.checkpoint.Checkpointer` restores through the
port's `restore_dict` with equal arrays (bfloat16 as a torch tensor of the
same raw bits) and the reverse; both write the same manifest and the same
leaf bytes for the same tree. Also: a ``.tmp`` step is never the latest, an
async write's failure surfaces on the next `save` or `wait`, old steps are
collected, and `restore(step, like)` rebuilds the ``like`` tree's
structure with tensors where ``like`` had tensors.
"""
import json
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer


def _numpy_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "registry": {
            "templates": rng.random((4, 2, 8)).astype(np.float32),
            "valid": rng.random((4, 2)) > 0.5,
            "slot_used": np.array([True, False]),
            "counts": rng.integers(-5, 5, (3,)).astype(np.int32),
        },
        "meta": np.frombuffer(b'{"format": 1}', np.uint8).copy(),
        "scale": rng.random((2, 3)).astype(np.float64),
        "steps": np.arange(4, dtype=np.int64),
    }


def _bf16_bits(seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def _assert_tree_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_tree_equal(g, w)
        else:
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_jax_step_restores_in_the_port(tmp_path):
    tree = _numpy_tree()
    bits = _bf16_bits()
    tree["weights_bf16"] = jnp.asarray(bits.view(ml_dtypes.bfloat16))
    tree["half"] = np.arange(6, dtype=np.float16)
    JCheckpointer(tmp_path).save(3, tree)
    got = Checkpointer(tmp_path).restore_dict(3)
    bf16 = got.pop("weights_bf16")
    assert isinstance(bf16, torch.Tensor) and bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf16.view(torch.int16).numpy().view(np.uint16), bits)
    tree.pop("weights_bf16")
    _assert_tree_equal(got, tree)


def test_port_step_restores_in_jax(tmp_path):
    tree = _numpy_tree(2)
    bits = _bf16_bits(3)
    tree["weights_bf16"] = torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16)
    tree["registry"]["lower"] = torch.linspace(-1, 1, 12).reshape(3, 4)
    Checkpointer(tmp_path).save(7, tree)
    got = JCheckpointer(tmp_path).restore_dict(7)
    assert got["weights_bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["weights_bf16"].view(np.uint16), bits)
    np.testing.assert_array_equal(got["registry"]["lower"],
                                  tree["registry"]["lower"].numpy())
    assert got["registry"]["lower"].dtype == np.float32
    for k in ("templates", "valid", "slot_used", "counts"):
        np.testing.assert_array_equal(got["registry"][k],
                                      tree["registry"][k])
    for k in ("meta", "scale", "steps"):
        np.testing.assert_array_equal(got[k], tree[k])


def test_same_manifest_and_leaf_bytes(tmp_path):
    tree = _numpy_tree(4)
    tree["nested"] = {"b": np.ones(3, np.int8), "a": [np.zeros(2, np.uint8),
                                                      (np.ones(1, bool),)]}
    JCheckpointer(tmp_path / "jax").save(0, tree)
    Checkpointer(tmp_path / "port").save(0, tree)
    jdir, tdir = tmp_path / "jax" / "step_00000000", \
        tmp_path / "port" / "step_00000000"
    jm = json.loads((jdir / "manifest.json").read_text())
    tm = json.loads((tdir / "manifest.json").read_text())
    assert tm == jm  # the treedef string included, for this tree
    assert list(tm["leaves"]) == list(jm["leaves"])  # leaf numbering
    for info in jm["leaves"].values():
        assert (tdir / info["file"]).read_bytes() == \
            (jdir / info["file"]).read_bytes()


def test_tmp_step_is_never_latest(tmp_path):
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() is None
    ck.save(1, {"x": np.ones(2, np.float32)})
    (tmp_path / "step_00000005.tmp").mkdir()  # a write killed mid-way
    (tmp_path / "step_00000004").mkdir()  # a step without its manifest
    assert ck.latest_step() == 1
    assert JCheckpointer(tmp_path).latest_step() == 1


def test_gc_keeps_the_newest_steps(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in range(4):
        ck.save(step, {"x": np.full(2, step, np.float32)})
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    np.testing.assert_array_equal(ck.restore_dict(3)["x"], [3.0, 3.0])


def test_async_save_is_durable_after_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    x = torch.arange(5, dtype=torch.float32)
    ck.save(0, {"x": x}, blocking=False)
    x.add_(100.0)  # the caller may change a leaf once save returns
    ck.wait()
    np.testing.assert_array_equal(ck.restore_dict(0)["x"],
                                  np.arange(5, dtype=np.float32))


@pytest.mark.parametrize("surface", ["save", "wait"])
def test_async_error_surfaces(tmp_path, monkeypatch, surface):
    ck = Checkpointer(tmp_path)

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", broken)
    ck.save(0, {"x": np.ones(1, np.float32)}, blocking=False)
    deadline = time.monotonic() + 30
    while ck._error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ck._error is not None, "the writer thread never failed"
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        if surface == "save":
            ck.save(1, {"x": np.ones(1, np.float32)})
        else:
            ck.wait()
    ck.wait()  # reported once


def test_restore_into_like_tree(tmp_path):
    like = {"w": torch.zeros(2, 3), "opt": {"mu": [np.zeros(2, np.float32),
                                                   torch.zeros((), dtype=
                                                               torch.int32)]},
            "b16": torch.zeros(4, dtype=torch.bfloat16), "none": None}
    saved = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"mu": [np.array([1.5, -2.0], np.float32),
                            torch.tensor(7, dtype=torch.int32)]},
             "b16": torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.bfloat16),
             "none": None}
    ck = Checkpointer(tmp_path)
    ck.save(2, saved)
    got = ck.restore(2, like)
    assert set(got) == set(like) and got["none"] is None
    assert isinstance(got["w"], torch.Tensor)
    assert torch.equal(got["w"], saved["w"])
    assert isinstance(got["opt"]["mu"][0], np.ndarray)
    np.testing.assert_array_equal(got["opt"]["mu"][0], saved["opt"]["mu"][0])
    assert torch.equal(got["opt"]["mu"][1], saved["opt"]["mu"][1])
    assert got["b16"].dtype == torch.bfloat16
    assert torch.equal(got["b16"], saved["b16"])
    # the JAX package reads the same step into its own like-tree
    jgot = JCheckpointer(tmp_path).restore(2, {
        "w": jnp.zeros((2, 3)), "opt": {"mu": [jnp.zeros(2),
                                               jnp.zeros((), jnp.int32)]},
        "b16": jnp.zeros(4, jnp.bfloat16), "none": None})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), saved["w"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jgot["b16"]).astype(np.float32),
        saved["b16"].float().numpy())
