"""The conv kernel's operands, made on the CPU (``ops/conv_cuda.py``).

The kernel takes its weights K-major, rounded to bf16 in the bf16 mode and
split into TF32 parts in the float32 mode. :func:`conv_cuda.prepared_weight`
makes that operand once per weight tensor and version, and the folded CRAFT
keeps its HWIO weights per module (``models/craft.py:_chain_conv``) so that
the same tensors reach the kernel every forward. These tests hold the cached
operands to the plain ones element for element, their lifetimes to the
changes that must renew them (``load_state_dict``, an in-place update,
``.to(...)``), the Cout-tile and K-slab tables that the wrapper gives the
kernel for every CRAFT layer, and C1's first layer as a 1x1 layer on its
im2col against the 3x3 layer.
"""

import numpy as np
import pytest
import torch

from keras_ocr_tpu_torch.models import CRAFT, init_parameters
from keras_ocr_tpu_torch.models.craft import _chain_conv
from keras_ocr_tpu_torch.ops import conv_cuda

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _weight(k, cin, cout, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(k, k, cin, cout).astype(np.float32))


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("k,cin,cout", [(3, 3, 64), (3, 5, 7), (1, 16, 2), (3, 64, 131),
                                        (1, 1536, 512)])
def test_prepared_operands_equal_the_plain_ones(dtype, k, cin, cout):
    """bf16: ``kmajor_weights(...).to(bfloat16)`` (for C1's first layer of
    the (1, 1, 27, Cout) im2col form, padded to 32 channels); float32:
    ``split_weights``; element for element, contiguous, 16-byte aligned."""
    w = _weight(k, cin, cout, seed=k * cin + cout)
    if conv_cuda.uses_im2col(k, cin, dtype):
        cin_pad = conv_cuda.IM2COL_CHANNELS
        want = conv_cuda.kmajor_weights(w.reshape(1, 1, 9 * cin, cout), cin_pad).to(BF16)
    else:
        multiple = conv_cuda.cin_multiple(dtype)
        cin_pad = -(-cin // multiple) * multiple
        want = (conv_cuda.kmajor_weights(w, cin_pad).to(BF16) if dtype == BF16
                else conv_cuda.split_weights(w, cin_pad))
    got = conv_cuda.prepared_weight(w, cin_pad, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "fp32"])
def test_prepared_operand_is_reused_until_the_tensor_changes(dtype):
    w = _weight(3, 8, 16)
    first = conv_cuda.prepared_weight(w, 8, dtype)
    assert conv_cuda.prepared_weight(w, 8, dtype) is first
    with torch.no_grad():
        w.mul_(2.0)
    renewed = conv_cuda.prepared_weight(w, 8, dtype)
    assert renewed is not first
    assert torch.equal(renewed, conv_cuda.weight_operand(w, 8, dtype))
    assert conv_cuda.prepared_weight(w, 8, dtype) is renewed
    # A copy is another tensor: its own operand, equal in value.
    copy = w.clone()
    assert conv_cuda.prepared_weight(copy, 8, dtype) is not renewed
    # Inference tensors keep no version counter: prepared per call.
    with torch.inference_mode():
        frozen = w.clone()
    one, two = (conv_cuda.prepared_weight(frozen, 8, dtype) for _ in range(2))
    assert one is not two and torch.equal(one, two)


def test_prepared_operand_dies_with_its_tensor():
    w = _weight(1, 16, 8)
    conv_cuda.prepared_weight(w, 16, BF16)
    key = id(w)
    assert key in conv_cuda._operands
    del w
    assert key not in conv_cuda._operands


def _folded(seed=0):
    return init_parameters(CRAFT(width=0.25, fold_bn=True), seed=seed).eval()


@pytest.mark.parametrize("change", ["none", "load_state_dict", "mul_", "to"])
def test_chain_operands_follow_the_module(change):
    """The folded CRAFT hands the kernel the same HWIO tensor (so its
    prepared operand) until the weight is reloaded, updated in place or
    moved (``.to``: here to float64, the CPU's other kind of move); then a
    new one equal to the fresh OIHW -> HWIO copy."""
    model = _folded()
    conv = model.basenet.slice2_14.conv
    hwio, bias, relu = _chain_conv(conv, True)
    assert torch.equal(hwio, conv.weight.detach().permute(2, 3, 1, 0))
    if change == "load_state_dict":
        model.load_state_dict(_folded(seed=1).state_dict())
    elif change == "mul_":
        with torch.no_grad():
            conv.weight.mul_(0.5)
    elif change == "to":
        model.to(torch.float64)
    again, bias_again, _ = _chain_conv(conv, True)
    if change == "none":
        assert again is hwio
    else:
        assert again is not hwio
        assert again.dtype == conv.weight.dtype
        assert torch.equal(again, conv.weight.detach().permute(2, 3, 1, 0))
    assert torch.equal(bias_again, conv.bias.detach())


def test_chain_operands_made_in_inference_mode_keep_a_version_counter():
    """Forwards run under ``torch.inference_mode``; the kept HWIO copy is
    made outside it, so that its operand can be cached and renewed."""
    conv = _folded().basenet.slice1_0.conv
    with torch.inference_mode():
        hwio, _, _ = _chain_conv(conv, True)
    assert not hwio.is_inference()
    operand = conv_cuda.prepared_weight(hwio, 32, BF16)
    with torch.inference_mode():
        assert _chain_conv(conv, True)[0] is hwio
    assert conv_cuda.prepared_weight(hwio, 32, BF16) is operand


# The 25 kernel layers of a 960x1280 folded CRAFT forward, batch 1 (the
# chains of ``chip_smoke.CRAFT_CHAINS``): (chain, layer, H, W, k, Cin,
# Cout), then the bf16 Cout tile, K slab and whether it runs on its im2col
# on 132 SMs, and the float32 Cout tile; measured on the H100 with
# ``scripts/conv_kernel_ab.py --tiles``.
CRAFT_TABLE = [
    ("C1", 0, 960, 1280, 3, 3, 64, 64, 32, True, 64),
    ("C1", 1, 960, 1280, 3, 64, 64, 64, 64, False, 64),
    ("C2", 0, 480, 640, 3, 64, 128, 128, 64, False, 128),
    ("C2", 1, 480, 640, 3, 128, 128, 128, 64, False, 128),
    ("C3", 0, 240, 320, 3, 128, 256, 256, 64, False, 128),
    ("C3", 1, 240, 320, 3, 256, 256, 256, 64, False, 128),
    ("C4", 0, 240, 320, 3, 256, 256, 256, 64, False, 128),
    ("C5", 0, 120, 160, 3, 256, 512, 256, 64, False, 128),
    ("C5", 1, 120, 160, 3, 512, 512, 256, 64, False, 128),
    ("C6", 0, 120, 160, 3, 512, 512, 256, 64, False, 128),
    ("C7", 0, 60, 80, 3, 512, 512, 256, 64, False, 128),
    ("C7", 1, 60, 80, 3, 512, 512, 256, 64, False, 128),
    ("upconv1", 0, 60, 80, 1, 1536, 512, 256, 64, False, 128),
    ("upconv1", 1, 60, 80, 3, 512, 256, 128, 64, False, 128),
    ("upconv2", 0, 120, 160, 1, 768, 256, 128, 64, False, 128),
    ("upconv2", 1, 120, 160, 3, 256, 128, 128, 64, False, 128),
    ("upconv3", 0, 240, 320, 1, 384, 128, 128, 64, False, 128),
    ("upconv3", 1, 240, 320, 3, 128, 64, 64, 64, False, 64),
    ("upconv4", 0, 480, 640, 1, 192, 64, 64, 64, False, 64),
    ("upconv4", 1, 480, 640, 3, 64, 32, 32, 64, False, 32),
    ("cls", 0, 480, 640, 3, 32, 32, 32, 32, False, 32),
    ("cls", 1, 480, 640, 3, 32, 32, 32, 32, False, 32),
    ("cls", 2, 480, 640, 3, 32, 16, 16, 32, False, 16),
    ("cls", 3, 480, 640, 1, 16, 16, 16, 16, False, 16),
    ("cls", 4, 480, 640, 1, 16, 2, 8, 16, False, 8),
]


@pytest.mark.parametrize("layer", CRAFT_TABLE, ids=lambda layer: f"{layer[0]}:{layer[1]}")
def test_tile_and_slab_tables_for_craft(layer):
    _, _, height, width, k, cin, cout, bn, slab, cols, fp32_bn = layer
    assert conv_cuda.uses_im2col(k, cin, BF16) == cols
    cin_pad = conv_cuda.IM2COL_CHANNELS if cols else -(-cin // 8) * 8
    tiles = conv_cuda.tiles_m(1, height, width)
    assert conv_cuda.tile_n(cout, tiles, BF16, 132) == bn
    assert conv_cuda.slab_channels(cin_pad, BF16) == slab
    assert conv_cuda.tile_n(cout, tiles, torch.float32, 132) == fp32_bn
    assert conv_cuda.slab_channels(-(-cin // 4) * 4, torch.float32) == 32
    assert not conv_cuda.uses_im2col(k, cin, torch.float32)


def test_tile_rule_counts_rounds():
    """256-wide where its rounds cost less than 1.5x fewer, 128-wide ones:
    a grid of one round either way keeps 128, more images tip it."""
    assert conv_cuda.tile_n(256, 40, BF16, 132) == 128        # upconv1's 3x3: 1 round each
    assert conv_cuda.tile_n(256, 150, BF16, 132) == 128       # upconv2's 1x1: 2 against 3
    assert conv_cuda.tile_n(256, 8 * 40, BF16, 132) == 256    # batch 8: 3 against 5
    assert conv_cuda.tile_n(512, 40, BF16, 132) == 256        # C7: 1 against 2
    assert conv_cuda.tile_n(512, 40, BF16, 16) == 256
    assert conv_cuda.tile_n(100, 10_000, BF16, 132) == 128
    assert conv_cuda.tile_n(512) == conv_cuda.tile_n(512, 10_000) == 128


@pytest.mark.parametrize("shape", [(2, 9, 13, 3), (1, 17, 16, 2), (3, 8, 21, 1)])
def test_im2col_layer_equals_the_3x3_layer(shape):
    """C1's first layer in bf16 runs as a 1x1 layer on its im2col columns
    with the prepared (1, 1, 27, Cout) operand: within one bf16 ulp of the
    plain 3x3 layer (the float32 sums only change order)."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(BF16)
    w, b = _weight(3, shape[3], 24, seed=shape[3]), torch.from_numpy(rng.randn(24).astype(np.float32))
    cols, operand, k, cin_pad = conv_cuda.kernel_operands(x, w)
    assert (k, cin_pad) == (1, 32) and cols.shape == (*shape[:3], 32)
    assert not cols[..., 9 * shape[3]:].any()
    as_1x1 = operand.float().permute(1, 2, 0).reshape(1, 1, 32, 24)
    got = conv_cuda.conv_chain_plain(cols, [(as_1x1, b, True)])
    want = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=True)
    assert float(conv_cuda.bf16_ulps(got, want).max()) <= 1.0
