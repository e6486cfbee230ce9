"""DeepSeek-V2/V3's MLA prefill attention (`kernels/mla_prefill`).

On the CPU: the plain version equals `chunked_attention` on the
concatenated q and k (k_rope expanded over the heads) at small MLA shapes,
S a multiple of neither 64 nor 128 and S below one tile among them;
`lm._mla_train_attention` keeps `chunked_attention` on the CPU, under grad,
at the tiny test widths (16 / 8 / 16) and when not causal, and the route
takes the kernel only for bf16 CUDA operands without grad, causal, at the
published widths, also for 512 sequences of 128 heads in `lm.features`
(B * H past grid.y's limit); the wrapper's stride rules; the benchmark's
`recorded_taps` still sees `_mla_train_attention` by its name.

On the card (marked ``card``, skipped without one; on a machine with a
card: ``python -m pytest -q -m card tests/test_torch_mla_prefill.py``): the
kernel against the plain version in bf16 at (1, 1,000, 4 heads) and (2,
4,096, 8 heads) within 2^-6 at unit scale (relative above it: p is rounded
to bf16 at each tile's running max in the kernel and at the row's in the
plain version, and the output is rounded to bf16); every output finite at
the ragged edges, the first row its first value; 512 sequences of 128
heads (B * H past grid.y's 65,535) against the plain version; a wrong
dtype, stride or alignment raises; one launch a layer in `lm.features` at the published
head widths and none in `lm.forward` under grad, each layer's attention
within bf16 rounding of `chunked_attention`'s. No JAX here: the card
tests compare with the plain PyTorch version.
"""
import dataclasses
import types

import pytest
import torch

from bench.harness import cells
from repro_torch.configs import deepseek_v3 as D
from repro_torch.kernels.mla_prefill import mla_prefill as mp
from repro_torch.models import layers as L
from repro_torch.models import lm

#: the published-smoke DeepSeek-V3 (every feature at CPU-test widths,
#: qk 16 + 8, v 16) in f32
TINY = dataclasses.replace(D.PUBLISHED_SMOKE, dtype=torch.float32)
#: the same at the published head widths (qk 128 + 64, v 128)
WIDE = dataclasses.replace(D.PUBLISHED_SMOKE, qk_nope_dim=128,
                           qk_rope_dim=64, v_head_dim=128)
#: bf16 against the plain version: 2^-6 at unit scale, relative above it
TOL_BF16 = 2.0 ** -6
SCALE = 192 ** -0.5 * L.yarn_mscale(40.0, 1.0) ** 2  # DeepSeek-V3's


def _ops(seed: int, b: int, s: int, h: int, widths=mp.WIDTHS,
         device="cpu", dtype=torch.float32, drawn_on="cpu") -> tuple:
    """(q_nope, q_rope, k_nope, k_rope, v) as the model hands them over:
    views of one (B, S, H, nope + rope) q and one (B, S, H, nope + v) kv,
    a contiguous q_rope and k_rope sliced from (B, S, 1, rope); drawn on
    ``drawn_on`` from ``seed``."""
    nope, rope, dv = widths
    g = torch.Generator(device=drawn_on).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=drawn_on).to(
            device=device, dtype=dtype)

    q, kv = draw(b, s, h, nope + rope), draw(b, s, h, nope + dv)
    return (q[..., :nope], draw(b, s, h, rope), kv[..., :nope],
            draw(b, s, 1, rope)[:, :, 0], kv[..., nope:])


def _chunked(q_nope, q_rope, k_nope, k_rope, v, scale, q_chunk=64):
    """The replaced path: q and k concatenated, `chunked_attention`."""
    b, s, h, _ = q_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, k_rope.shape[-1])], dim=-1)
    return L.chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
                               scale=scale)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, |want|) everywhere."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    assert float((diff / want.float().abs().clamp(min=1.0)).max()) <= tol


# ---------------------------------------------------------------------------
# the CPU: the plain version is `chunked_attention`'s arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, s, h", [(1, 1, 1), (2, 37, 3), (1, 64, 2),
                                     (1, 127, 1), (2, 129, 2), (1, 200, 4)])
@pytest.mark.parametrize("widths", [mp.WIDTHS, (16, 8, 16)])
def test_plain_is_chunked_attention(b, s, h, widths):
    """In f32 the two differ only by the order of f32 sums: the plain
    version divides by the row sum after P.V, `chunked_attention` before."""
    ops = _ops(s * 7 + h, b, s, h, widths)
    got = mp.mla_prefill_plain(*ops, scale=SCALE)
    want = _chunked(*ops, SCALE)
    assert got.shape == (b, s, h, widths[2])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [100, 300])
def test_plain_is_chunked_attention_in_bf16(s):
    """bf16 operands: both round p to bf16 (at other scales) and the
    output to bf16."""
    ops = _ops(s, 2, s, 2, dtype=torch.bfloat16)
    _close(mp.mla_prefill_plain(*ops, scale=SCALE, q_chunk=96),
           _chunked(*ops, SCALE), TOL_BF16)


def test_plain_first_row_is_its_value_and_chunks_agree():
    """Row 0 sees key 0 alone; the chunk size does not change a value."""
    ops = _ops(5, 1, 150, 2)
    out = mp.mla_prefill_plain(*ops, scale=SCALE)
    torch.testing.assert_close(out[:, 0], ops[4][:, 0])
    torch.testing.assert_close(
        mp.mla_prefill_plain(*ops, scale=SCALE, q_chunk=7), out,
        rtol=1e-6, atol=1e-6)


def test_wrapper_on_the_cpu_is_the_plain_version():
    ops = _ops(6, 1, 90, 2)
    mp.reset_launches()
    assert torch.equal(mp.mla_prefill(*ops, scale=SCALE),
                       mp.mla_prefill_plain(*ops, scale=SCALE))
    assert mp.LAUNCHES["mla_prefill"] == 0


def test_strides_are_the_tensor_maps():
    """(head, row, batch) element strides of the model's views; a size-1
    dim gets a stride the tensor map takes; a last dim that is not
    contiguous or a row off 16 bytes is refused."""
    q_nope, _, k_nope, k_rope, v = _ops(1, 2, 10, 3)
    assert mp._strides("q_nope", q_nope) == [192, 3 * 192, 10 * 3 * 192]
    assert mp._strides("v", v) == [256, 3 * 256, 10 * 3 * 256]
    assert mp._strides("k_rope", k_rope) == [64, 10 * 64]
    one = torch.zeros((1, 5, 1, 128))
    assert mp._strides("q_nope", one) == [128, 128, 5 * 128]
    with pytest.raises(ValueError, match="contiguous"):
        mp._strides("q_nope", torch.zeros((1, 5, 128, 2)).transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte"):
        mp._strides("q_nope", torch.zeros((1, 5, 2, 132))[..., :128])


# ---------------------------------------------------------------------------
# the CPU: the route
# ---------------------------------------------------------------------------

def _card_like(dtype=torch.bfloat16):
    """What the route reads of q_nope, as a CUDA tensor would give it."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


def test_route_takes_the_kernel_only_where_it_applies():
    wide = dataclasses.replace(WIDE, dtype=torch.bfloat16)
    with torch.no_grad():
        assert lm._mla_prefill_kernel(wide, _card_like())
        assert not lm._mla_prefill_kernel(wide, _card_like(torch.float32))
        assert not lm._mla_prefill_kernel(D.PUBLISHED_SMOKE, _card_like())
        assert not lm._mla_prefill_kernel(
            dataclasses.replace(wide, causal=False), _card_like())
        assert not lm._mla_prefill_kernel(
            wide, torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16))
    with torch.enable_grad():
        assert not lm._mla_prefill_kernel(wide, _card_like())


def test_launch_args_take_any_number_of_sequences_and_heads():
    """The grid is flat: 512 sequences of 128 heads (B * H = 65,536, past
    grid.y's 65,535) are a launch like any other; what the kernel does not
    take is refused on any device."""
    ops = _ops(9, 512, 2, 128, dtype=torch.bfloat16)
    b, s, h, strides = mp._launch_args(*ops)
    assert (b, s, h) == (512, 2, 128) and b * h > 65535
    assert strides[:3] == [192, 128 * 192, 2 * 128 * 192]
    with pytest.raises(TypeError, match="bfloat16"):
        mp._launch_args(*(x.float() for x in ops))
    with pytest.raises(ValueError, match="expected"):
        mp._launch_args(ops[0], *ops[1:4], ops[4][:, :1])


def test_features_of_512_sequences_of_128_heads_take_the_route(monkeypatch):
    """`lm.features` at 512 sequences of 128 heads (`fit_acam_head`'s
    default batch at DeepSeek-V3's heads), with the route shown a card's
    operands: the kernel's launch arguments once a layer, B * H = 65,536,
    and nothing refused."""
    cfg = dataclasses.replace(WIDE, n_heads=128, n_kv_heads=128,
                              dtype=torch.bfloat16)
    route = lm._mla_prefill_kernel
    monkeypatch.setattr(lm, "_mla_prefill_kernel",
                        lambda cfg, q: route(cfg, _card_like(q.dtype)))
    launched = []

    def kernel(*ops, scale):
        launched.append(mp._launch_args(*ops)[:3])
        return mp.mla_prefill_plain(*ops, scale=scale)

    monkeypatch.setattr(mp, "mla_prefill", kernel)
    params = lm.init_params(0, cfg, device="cpu")
    x = torch.randint(0, cfg.vocab, (512, 3),
                      generator=torch.Generator().manual_seed(7))
    assert torch.isfinite(lm.features(params, cfg, x)).all()
    assert launched == [(512, 3, 128)] * cfg.n_layers


@pytest.fixture
def refuse_kernel(monkeypatch):
    """`mla_prefill.mla_prefill` raising if anything calls it."""
    def refused(*args, **kw):
        raise AssertionError("the MLA prefill kernel was called")

    monkeypatch.setattr(mp, "mla_prefill", refused)


@pytest.mark.parametrize("case", ["cpu_wide", "grad", "tiny", "not_causal"])
def test_mla_attention_keeps_chunked_attention(case, refuse_kernel):
    """`_mla_train_attention` on the CPU (at the published widths too),
    under grad, at the tiny widths and when not causal: the concatenated q
    and k through `chunked_attention`, as before."""
    cfg = {"cpu_wide": WIDE, "grad": TINY, "tiny": TINY,
           "not_causal": dataclasses.replace(TINY, causal=False)}[case]
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = lm.init_params(0, cfg, device="cpu")
    attn = params.layers[0].attn
    if case == "grad":
        for p in attn.parameters():
            p.requires_grad_(True)
    h = torch.randn((2, 21, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(21)[None].expand(2, 21)
    with torch.set_grad_enabled(case == "grad"):
        out, c_kv, k_rope = lm._mla_train_attention(attn, cfg, h, pos)
        q_nope, q_rope = lm._mla_q(attn, cfg, h, pos)
        kv = L.linear(attn.kv_b, c_kv).reshape(
            2, 21, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
        k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            2, 21, cfg.n_heads, cfg.qk_rope_dim)], dim=-1)
        core = L.chunked_attention(q, k, v, causal=cfg.causal,
                                   q_chunk=cfg.q_chunk,
                                   scale=cfg.softmax_scale)
        want = L.linear(attn.o, core.reshape(2, 21, -1))
    assert out.requires_grad == (case == "grad")
    assert torch.equal(out, want)
    assert c_kv.shape == (2, 21, cfg.kv_lora_rank)
    assert k_rope.shape == (2, 21, cfg.qk_rope_dim)


def test_recorded_taps_sees_mla_attention():
    """The LM cell's check records each layer's attention by patching
    `lm._mla_train_attention` by its name: `lm.features` still reaches the
    patched function, once a layer, with the input and output it gives."""
    traffic = cells.load_module("traffic", "lm_classify")
    params = lm.init_params(0, TINY, device="cpu")
    x = torch.randint(0, TINY.vocab, (2, 19),
                      generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        plain = lm.features(params, TINY, x)
        with traffic.recorded_taps() as taps:
            recorded = lm.features(params, TINY, x)
    assert lm._mla_train_attention.__name__ == "_mla_train_attention"
    assert len(taps["attn"]) == TINY.n_layers
    for h, out in taps["attn"]:
        assert h.shape == (2, 19, TINY.d_model) == out.shape
    assert torch.equal(recorded, plain)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("b, s, h", [(1, 1000, 4), (2, 4096, 8)])
def test_card_kernel_against_plain(card, b, s, h):
    ops = _ops(b * s + h, b, s, h, device=card, dtype=torch.bfloat16)
    mp.reset_launches()
    got = mp.mla_prefill(*ops, scale=SCALE)
    assert mp.LAUNCHES["mla_prefill"] == 1
    assert got.is_contiguous() and got.shape == (b, s, h, 128)
    _close(got, mp.mla_prefill_plain(*ops, scale=SCALE), TOL_BF16)


@pytest.mark.card
def test_card_kernel_past_grid_y(card):
    """512 sequences of 128 heads: B * H = 65,536 blocks of one query
    tile, more than grid.y holds, against the plain version."""
    ops = _ops(65536, 512, 130, 128, device=card, dtype=torch.bfloat16,
               drawn_on=card)
    mp.reset_launches()
    got = mp.mla_prefill(*ops, scale=SCALE)
    assert mp.LAUNCHES["mla_prefill"] == 1
    _close(got, mp.mla_prefill_plain(*ops, scale=SCALE, q_chunk=64),
           TOL_BF16)


@pytest.mark.card
@pytest.mark.parametrize("s", [1, 2, 127, 128, 129, 255])
def test_card_edges_are_finite(card, s):
    """S of one key, and one either side of a tile: no NaN anywhere, row 0
    its one live value, and the plain version's answer."""
    ops = _ops(s, 2, s, 3, device=card, dtype=torch.bfloat16)
    got = mp.mla_prefill(*ops, scale=SCALE)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, 0], ops[4][:, 0])
    _close(got, mp.mla_prefill_plain(*ops, scale=SCALE), TOL_BF16)


@pytest.mark.card
def test_card_refuses_what_the_kernel_does_not_take(card):
    ops = list(_ops(8, 1, 64, 2, device=card, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        mp.mla_prefill(*(x.float() for x in ops), scale=SCALE)
    transposed = ops[0].contiguous().transpose(1, 2).contiguous() \
        .transpose(1, 2)
    assert transposed.stride(-1) == 1
    odd = torch.zeros((1, 64, 2, 130), dtype=torch.bfloat16,
                      device=card)[..., 1:129]
    with pytest.raises(ValueError, match="aligned"):
        mp.mla_prefill(odd, *ops[1:], scale=SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        mp.mla_prefill(ops[0].transpose(2, 3).contiguous().transpose(2, 3),
                       *ops[1:], scale=SCALE)
    with pytest.raises(ValueError, match="expected"):
        mp.mla_prefill(ops[0][..., :64], *ops[1:], scale=SCALE)
    # strides the model never gives but the tensor map takes
    _close(mp.mla_prefill(transposed, *ops[1:], scale=SCALE),
           mp.mla_prefill_plain(transposed, *ops[1:], scale=SCALE), TOL_BF16)


@pytest.mark.card
def test_card_features_launch_once_a_layer(card, monkeypatch):
    """`lm.features` (always without grad) at the published head widths in
    bf16: one launch a layer, and none in `lm.forward` under grad. Each
    layer's attention on one input is within bf16 rounding of the same call
    through `chunked_attention`; the features are not compared, because the
    router after the attention turns a rounding into another expert."""
    params = lm.init_params(0, WIDE, device=card)
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randint(0, WIDE.vocab, (2, 300), device=card, generator=g)
    mp.reset_launches()
    assert torch.isfinite(lm.features(params, WIDE, x)).all()
    assert mp.LAUNCHES["mla_prefill"] == WIDE.n_layers
    with torch.enable_grad():
        lm.forward(params, WIDE, x)
    assert mp.LAUNCHES["mla_prefill"] == WIDE.n_layers
    h = torch.randn((2, 300, WIDE.d_model), generator=g,
                    device=card).to(WIDE.dtype)
    pos = lm._default_positions(WIDE, 2, 300, device=card)
    with torch.no_grad():
        for layer in params.layers:
            got = lm._mla_train_attention(layer.attn, WIDE, h, pos)[0]
            with monkeypatch.context() as patch:
                patch.setattr(lm, "_mla_prefill_kernel", lambda *args: False)
                want = lm._mla_train_attention(layer.attn, WIDE, h, pos)[0]
            gap = (got.float() - want.float()).norm() / want.float().norm()
            assert float(gap) <= TOL_BF16
    assert mp.LAUNCHES["mla_prefill"] == 2 * WIDE.n_layers
