"""The port's flash attention (B9) and `chunked_attention` against the JAX
package's, on the CPU.

On the CPU the port's wrappers run their plain version; the JAX package
runs its Pallas kernel in interpret mode with 128 x 128 tiles, as
`tests/test_kernels.py` does. Tolerances: 2e-3 in f32 (that test's own);
in bf16 2^-6 at unit scale and relative above it (about four ulps of
bf16's 2^-8 unit roundoff): both versions round p to bf16 before P.V, the
JAX kernel at each tile's running max and the plain version at the row's
final max, and the output is rounded to bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash_attention
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models.layers import chunked_attention as jchunked_attention
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as tattention_ref
from repro_torch.models.layers import chunked_attention as tchunked_attention

SHAPES = [(2, 200, 8, 2, 64, True), (1, 128, 4, 4, 128, True),
          (2, 333, 6, 2, 64, False), (1, 512, 2, 1, 32, True)]
BF16_TOL = 2.0 ** -6


def _qkv(seed, b, sq, h, kv, d, sk=None, dv=None):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dv or d)).astype(np.float32))


def _to_np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def _assert_bf16_close(got: np.ndarray, want: np.ndarray):
    """|got - want| <= 2^-6 * max(1, |want|)."""
    scaled = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert scaled.max() <= BF16_TOL, scaled.max()


@pytest.mark.parametrize("b,s,h,kv,d,causal", SHAPES)
def test_attention_against_jax(b, s, h, kv, d, causal):
    q, k, v = _qkv(s + h, b, s, h, kv, d)
    got = tfa_ops.attention(t(q), t(k), t(v), causal=causal)
    want = np.asarray(jfa_ops.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        block=(128, 128)))
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    # the JAX oracle on the expanded heads, and the port's copy of it
    g = h // kv
    kx, vx = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)

    def flat(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    ref = np.asarray(jattention_ref(jnp.asarray(flat(q)), jnp.asarray(flat(kx)),
                                    jnp.asarray(flat(vx)), causal=causal))
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d), ref,
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        tattention_ref(t(flat(q)), t(flat(kx)), t(flat(vx)),
                       causal=causal).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16(causal):
    """bf16 operands: p rounded to bf16 before P.V in both, output bf16."""
    q, k, v = _qkv(7, 2, 200, 8, 2, 64)
    q16, k16, v16 = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (q, k, v))
    got = tfa_ops.attention(q16, k16, v16, causal=causal)
    assert got.dtype == torch.bfloat16
    want = jfa_ops.attention(*(jnp.asarray(_to_np(a), jnp.bfloat16)
                               for a in (q16, k16, v16)),
                             causal=causal, block=(128, 128))
    assert want.dtype == jnp.bfloat16
    _assert_bf16_close(_to_np(got), np.asarray(want, np.float32))


def test_three_dim_face_against_jax():
    """The (BH, S, D) face with its own ragged key length and Sq != Sk."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 70, 32)).astype(np.float32)
    k = rng.standard_normal((3, 150, 32)).astype(np.float32)
    v = rng.standard_normal((3, 150, 32)).astype(np.float32)
    for causal in (True, False):
        got = tfa.flash_attention(t(q), t(k), t(v), causal=causal,
                                  block=(64, 64))
        want = np.asarray(jflash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block=(64, 64), interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal,window,q_offset,q_chunk", [
    (True, None, 0, 64), (False, None, 0, 512), (True, 24, 0, 48),
    (True, None, 40, 64), (True, 16, 40, 32), (True, None, -20, 64)])
def test_chunked_attention_against_jax(causal, window, q_offset, q_chunk):
    """GQA, a ragged last chunk, sliding windows, q positioned inside the kv
    stream; q_offset -20 leaves the first rows with no key (zeros, no NaN)."""
    q, k, v = _qkv(11, 2, 100, 4, 2, 32, sk=140)
    got = tchunked_attention(t(q), t(k), t(v), causal=causal,
                             q_chunk=q_chunk, window=window,
                             q_offset=q_offset)
    want = np.asarray(jchunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=q_chunk, window=window, q_offset=q_offset))
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if q_offset < 0:
        assert not got[:, :-q_offset].any()


def test_chunked_attention_bf16_and_mla_widths():
    """bf16 operands (output in v's dtype) and a v head dim unlike q's."""
    q, k, v = _qkv(12, 1, 90, 4, 4, 48, dv=32)
    got = tchunked_attention(t(q), t(k), t(v), causal=True, q_chunk=32)
    want = jchunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_chunk=32)
    assert got.shape == (1, 90, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    q16, k16, v16 = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (q, k, v))
    got = tchunked_attention(q16, k16, v16, causal=True, q_chunk=32)
    want = jchunked_attention(*(jnp.asarray(_to_np(a), jnp.bfloat16)
                                for a in (q16, k16, v16)),
                              causal=True, q_chunk=32)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(_to_np(got), np.asarray(want, np.float32))


def test_attention_matches_chunked_attention():
    """The kernel's entry point equals the model's chunked attention (the
    port's twin of the JAX package's own check)."""
    q, k, v = _qkv(1, 2, 160, 4, 2, 32)
    got = tfa_ops.attention(t(q), t(k), t(v), causal=True, block=(64, 64))
    want = tchunked_attention(t(q), t(k), t(v), causal=True, q_chunk=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _qkv(2, 1, 40, 2, 1, 32)
    tfa.reset_launches()
    got = tfa.flash_attention_gqa(t(q), t(k), t(v), causal=True)
    assert tfa.LAUNCHES["flash_attention"] == 0
    np.testing.assert_array_equal(
        got.numpy(),
        tfa.flash_attention_gqa_plain(t(q), t(k), t(v), causal=True).numpy())


@pytest.mark.parametrize("dtype,d,route", [
    *((dt, d, tfa.TENSOR_CORE) for dt in (torch.bfloat16, torch.float16)
      for d in (32, 64, 96, 128)),
    *((torch.float32, d, tfa.FP32) for d in (32, 64, 96, 128))])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    """bf16 and f16 run on the tensor cores, f32 on FP32 FMAs (tensor cores
    would round f32 to TF32); decided on the CPU, nothing launched."""
    tfa.reset_launches()
    assert tfa.route(dtype, d) == route
    assert tfa.LAUNCHES["flash_attention"] == 0


def test_route_rejects_what_the_card_does_not_take():
    with pytest.raises(ValueError, match="head dims"):
        tfa.route(torch.bfloat16, 80)
    with pytest.raises(TypeError, match="float32, bfloat16, float16"):
        tfa.route(torch.float64, 64)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_shape_bound():
    """The timed model shape is qwen3-1.7b's attention (16 query heads, 8
    kv heads, head dim 128) at 4096 tokens; causal, it needs 4 * 128 flops
    for each of 4096 * 4097 / 2 live pairs per head: 68.7 GFLOP, 0.0695 ms
    at 989 TFLOP/s, well above its 50 MB over 3.35 TB/s."""
    from repro.configs.qwen3_1_7b import CONFIG

    cs = _chip_smoke()
    b, s, h, kv, d = cs.FA_MODEL_SHAPE
    assert (h, kv, d) == (CONFIG.n_heads, CONFIG.n_kv_heads, CONFIG.head_dim)
    ms, by, flops, nbytes = cs.fa_bound(b, s, h, kv, d, True, torch.bfloat16)
    assert flops == 4 * 128 * (4096 * 4097 // 2) * 16 == 68_736_253_952
    assert nbytes == (2 * 4096 * 16 * 128 + 2 * 4096 * 8 * 128) * 2
    assert by == "operations"
    assert ms == pytest.approx(flops / 989e12 * 1e3) and 0.0695 < ms < 0.0696
