"""The Fig. 5 student's fused epilogue (`kernels/student_epilogue`).

On the CPU: the wrapper's plain version against the chain `Student.features`
runs (conv with its bias, ReLU, eval BatchNorm, 2x2 max-pool with the
floor), bit for bit, at 30 -> 15 and 15 -> 7, with and without int8
fake-quant and with negative BatchNorm scales; a NaN pixel propagates as
the chain propagates it; `features` keeps the chain in train mode, under
grad and for CPU tensors, and launches nothing.

On the card (marked ``card``, skipped without one; on a machine with a
card: ``python -m pytest -q -m card tests/test_torch_student_epilogue.py``):
the kernel `torch.equal` to the plain version at the frames cell's batch
(4,096) and at ragged ones, with the plain version's strides; four launches
an eval `features` call and none in a training forward; a refused launch
and a conv output in another memory format raise. No JAX here: the card
tests compare with the plain PyTorch version.
"""
import copy

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.quant import fake_quant_int8
from repro_torch.kernels.student_epilogue import student_epilogue as epi
from repro_torch.models import cnn

PAPER = (32, 128, 256, 16)
#: widths off the kernel's 16-byte path (3, 6, 10, 2 channels: one a
#: thread) and 12 (three vectors of 4, so 255-thread blocks)
ODD = (3, 6, 10, 12)


def _student(seed: int, device="cpu", filters=PAPER) -> cnn.Student:
    """The student (the paper's widths by default) with small conv biases
    and BatchNorm statistics a trained front end carries; about half the
    BatchNorm scales are negative (BN then does not commute with the
    pool)."""
    model = cnn.init_student(torch.Generator().manual_seed(seed),
                             cnn.StudentConfig(filters=filters),
                             device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for conv in (model.conv1, model.conv2, model.conv3, model.conv4):
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=g))
        for bn in (model.bn1, model.bn2):
            c = bn.num_features
            bn.weight.copy_(0.8 * torch.randn(c, generator=g))
            bn.bias.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
        assert (model.bn1.weight < 0).any() and (model.bn2.weight < 0).any()
    return model.to(device)


def _images(seed: int, b: int, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 32, 32, 1), generator=g).to(device)


def _weight(m, quantize: bool):
    return fake_quant_int8(m.weight) if quantize else m.weight


def _chain(model: cnn.Student, x, *, quantize=False, train=False,
           upto: int = 4):
    """The unfused chain of `Student.features`, written out: the output of
    block ``upto`` (1-3), or the NHWC-flat features (4)."""
    def conv(m, h):
        return F.relu(F.conv2d(h, _weight(m, quantize), m.bias,
                               padding=m.padding))

    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(cnn.batchnorm(model.bn1, conv(model.conv1, h),
                                   train=train), 2)
    if upto == 1:
        return h
    h = F.max_pool2d(cnn.batchnorm(model.bn2, conv(model.conv2, h),
                                   train=train), 2)
    if upto == 2:
        return h
    h = conv(model.conv3, h)
    if upto == 3:
        return h
    h = conv(model.conv4, h)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _stage(model: cnn.Student, block: int, h, *, quantize=False,
           fn=epi.conv_epilogue):
    """Block ``block`` (1-4) of the fused path on ``h`` through ``fn``: the
    wrapper (default) or the plain version."""
    conv = (model.conv1, model.conv2, model.conv3, model.conv4)[block - 1]
    bn = {1: model.bn1, 2: model.bn2}.get(block)
    return fn(h, _weight(conv, quantize), conv.bias, conv.padding, bn,
              flatten=block == 4)


def _input_of(model, x, block: int, quantize=False):
    h = x.permute(0, 3, 1, 2)
    return h if block == 1 else _chain(model, x, quantize=quantize,
                                       upto=block - 1)


def _assert_same(got, want):
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


SHAPES = {1: (32, 15, 15), 2: (128, 7, 7), 3: (256, 7, 7), 4: (784,)}


# ---------------------------------------------------------------------------
# the CPU: the plain version is today's chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("block", [1, 2, 3, 4])
def test_plain_block_is_the_chain(block, quantize):
    """Each block's plain version (and the wrapper, which takes it for CPU
    tensors) equals the chain's block bit for bit, strides included: 30 ->
    15 and 15 -> 7 with the floor, bias + ReLU, the NHWC-flat features."""
    model, x = _student(3), _images(4, 5)
    with torch.no_grad():
        h = _input_of(model, x, block, quantize)
        want = _chain(model, x, quantize=quantize, upto=block)
        for fn in (epi.conv_epilogue_plain, epi.conv_epilogue):
            got = _stage(model, block, h, quantize=quantize, fn=fn)
            assert tuple(got.shape[1:]) == SHAPES[block]
            _assert_same(got, want)


@pytest.mark.parametrize("filters", [PAPER, ODD])
@pytest.mark.parametrize("quantize", [False, True])
def test_plain_blocks_compose_to_features(quantize, filters):
    """The four plain blocks in turn give `Student.features`' output on the
    CPU, bit for bit."""
    model, x = _student(5, filters=filters), _images(6, 7)
    with torch.no_grad():
        h = x.permute(0, 3, 1, 2)
        for block in (1, 2, 3, 4):
            h = _stage(model, block, h, quantize=quantize,
                       fn=epi.conv_epilogue_plain)
        _assert_same(h, model.features(x, quantize=quantize))
        _assert_same(h, _chain(model, x, quantize=quantize))


@pytest.mark.parametrize("block", [1, 2, 3, 4])
def test_nan_pixel_propagates(block):
    """A NaN input pixel reaches the block's output where the chain puts
    it (ReLU and the pool keep NaN), and nowhere else."""
    model, x = _student(7), _images(8, 3)
    with torch.no_grad():
        h = _input_of(model, x, block).clone()
        h[1, :, 3, 4] = float("nan")
        got = _stage(model, block, h, fn=epi.conv_epilogue_plain)
        conv = (model.conv1, model.conv2, model.conv3, model.conv4)[block - 1]
        want = F.relu(F.conv2d(h, conv.weight, conv.bias,
                               padding=conv.padding))
        if block <= 2:
            bn = model.bn1 if block == 1 else model.bn2
            want = F.max_pool2d(cnn.batchnorm(bn, want, train=False), 2)
        if block == 4:
            want = want.permute(0, 2, 3, 1).reshape(3, -1)
        assert torch.isnan(got).any() and not torch.isnan(got[0]).any()
        _assert_same(got, want)


@pytest.mark.parametrize("mode", ["eval", "train", "grad", "quantize_grad"])
def test_features_on_the_cpu_take_the_chain(mode):
    """On CPU tensors `features` runs the chain in every mode (eval, train
    mode, under grad, int8 fake-quant under grad) and launches nothing."""
    model, x = _student(9), _images(10, 4)
    twin = copy.deepcopy(model)
    train, quantize = mode == "train", mode == "quantize_grad"
    epi.reset_launches()
    with torch.set_grad_enabled(mode != "eval"):
        got = model.features(x, quantize=quantize, train=train)
        want = _chain(twin, x, quantize=quantize, train=train)
    assert epi.LAUNCHES["student_epilogue"] == 0
    assert got.requires_grad == (mode != "eval")
    _assert_same(got.detach(), want.detach())
    if train:  # the running statistics moved the same way
        assert torch.equal(model.bn1.running_var, twin.bn1.running_var)


def test_epilogue_takes_cuda_tensors_only():
    raw = torch.zeros((1, 4, 4, 4)).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        epi.epilogue(raw, torch.zeros(4))
    assert epi.LAUNCHES["student_epilogue"] == 0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    device = torch.device("cuda", 0)
    with torch.no_grad(), cnn.fp32(device):
        yield device


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 3, 97, 4096])
def test_card_blocks_equal_plain(card, b):
    """Each fused block `torch.equal` to its plain version on the card at
    the frames cell's batch and ragged ones, with the plain strides; one
    launch a block."""
    model, x = _student(11, card), _images(12, b, card)
    for block in (1, 2, 3, 4):
        h = _input_of(model, x, block)
        epi.reset_launches()
        got = _stage(model, block, h)
        assert epi.LAUNCHES["student_epilogue"] == 1
        _assert_same(got, _stage(model, block, h,
                                 fn=epi.conv_epilogue_plain))


@pytest.mark.card
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("b", [3, 4096])
def test_card_features_equal_the_chain(card, b, quantize):
    """Eval `features` on the card: four launches a call, the chain's
    features bit for bit (NHWC-flat, contiguous)."""
    model, x = _student(13, card), _images(14, b, card)
    for calls in (1, 2):
        epi.reset_launches()
        for _ in range(calls):
            got = model.features(x, quantize=quantize)
        assert epi.LAUNCHES["student_epilogue"] == 4 * calls
    _assert_same(got, _chain(model, x, quantize=quantize))
    assert got.is_contiguous()


@pytest.mark.card
def test_card_other_widths_equal_the_chain(card):
    """Widths off the 16-byte path and channel groups that do not divide a
    256-thread block: four launches, the chain's features bit for bit."""
    model, x = _student(19, card, filters=ODD), _images(20, 37, card)
    epi.reset_launches()
    got = model.features(x)
    assert epi.LAUNCHES["student_epilogue"] == 4
    _assert_same(got, _chain(model, x))


@pytest.mark.card
def test_card_nan_propagates(card):
    model, x = _student(15, card), _images(16, 5, card)
    x[2, 7, 9, 0] = float("nan")
    got = model.features(x)
    assert torch.isnan(got[2]).any() and not torch.isnan(got[0]).any()
    _assert_same(got, _chain(model, x))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["train", "grad", "quantize_grad"])
def test_card_training_forward_takes_the_chain(card, mode):
    """Train mode and any forward under grad keep the chain on the card:
    no launch (the KD step's path)."""
    model, x = _student(17, card), _images(18, 8, card)
    twin = copy.deepcopy(model)
    train, quantize = mode == "train", mode == "quantize_grad"
    epi.reset_launches()
    with torch.enable_grad():
        got = model.features(x, quantize=quantize, train=train)
        want = _chain(twin, x, quantize=quantize, train=train)
    assert epi.LAUNCHES["student_epilogue"] == 0 and got.requires_grad
    _assert_same(got.detach(), want.detach())


@pytest.mark.card
def test_card_refused_launches_raise(card):
    """More channel groups than a block holds (4,100 channels: 1,025
    vectors of 4) is refused at launch and raises; so does a conv output
    in another memory format, before any launch."""
    epi.reset_launches()
    wide = torch.zeros((1, 4100, 2, 2), device=card).to(
        memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="CUDA error"):
        epi.epilogue(wide, torch.zeros(4100, device=card))
    nchw = torch.zeros((2, 16, 7, 7), device=card)
    with pytest.raises(ValueError, match="channels-last"):
        epi.epilogue(nchw, torch.zeros(16, device=card))
    assert epi.LAUNCHES["student_epilogue"] == 0
