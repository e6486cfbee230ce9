"""The dry run's cell shapes (`repro_torch.launch.shapes`) against the JAX
package's `repro.launch.shapes`: the same shape table and applicability
for every architecture, and the same input shapes and dtypes (meta
tensors where JAX has ``ShapeDtypeStruct``s), SMOKE and full width, every
decode cache field included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.launch import shapes as tshapes

ARCHS = tconfigs.list_archs()


def _sig(x) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(x, torch.Tensor):
        assert x.is_meta
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), jnp.dtype(x.dtype).name


def test_shape_table_is_jaxs():
    assert tshapes.SHAPES == jshapes.SHAPES
    assert tshapes.SHAPE_IDS == jshapes.SHAPE_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_is_jaxs(arch):
    for shape_id in jshapes.SHAPE_IDS:
        assert tshapes.applicable(tconfigs.get(arch), shape_id) == \
            jshapes.applicable(jconfigs.get(arch), shape_id)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_jaxs(arch, smoke):
    for shape_id in jshapes.SHAPE_IDS:
        got = tshapes.input_specs(tconfigs.get(arch), shape_id, smoke=smoke)
        want = jshapes.input_specs(jconfigs.get(arch), shape_id,
                                   smoke=smoke)
        assert (got.kind, got.seq, got.batch) == (want.kind, want.seq,
                                                  want.batch)
        assert len(got.args) == len(want.args)
        if got.kind == "train":
            (g,), (w,) = got.args, want.args
            assert set(g) == set(w)
            for k in w:
                assert _sig(g[k]) == _sig(w[k]), (shape_id, k)
            continue
        if got.kind == "prefill":
            for g, w in zip(got.args, want.args):
                assert _sig(g) == _sig(w), shape_id
            continue
        (g_tok, g_cache), (w_tok, w_cache) = got.args, want.args
        assert _sig(g_tok) == _sig(w_tok), shape_id
        for f in w_cache._fields[:-1]:  # every tensor field, then length
            g, w = getattr(g_cache, f), getattr(w_cache, f)
            assert (g is None) == (w is None), (shape_id, f)
            if w is not None:
                assert _sig(g) == _sig(w), (shape_id, f)
        assert g_cache.length == 0 and np.shape(w_cache.length) == ()


def test_input_specs_allocate_nothing():
    """A full-width deepseek-v3 decode cell: a cache of 128 x 32768 slots
    and 61 layers lives on the meta device only."""
    spec = tshapes.input_specs(tconfigs.get("deepseek-v3-671b"),
                               "decode_32k")
    cache = spec.args[1]
    assert cache.c_kv.is_meta and cache.c_kv.shape[:3] == (61, 128, 32768)
