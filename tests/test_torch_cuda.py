"""The port's CUDA kernels on the card (marked ``cuda``): both entries of
the sweep kernel (the label sweeps and the keyed row/column runs; odd
widths, tall maps, the line limit, every barrier type, images that stop
at their fixpoint at different sweeps) and both
conv wrappers (``conv_chain``, ``conv3x3_bias_act``), against their plain
versions; the BN-folded CRAFT through the conv kernel against the unfolded
graph; ``torch.library.opcheck`` of the three kernel ops on CUDA tensors;
the golden pipeline exported on the card against the live device program,
with the kernels' launch counts advancing during the artifact's run; one
full-width train step of the CRNN and of CRAFT (MSE and OHEM) on the card
against the same step on the CPU (losses in float32, gradients in float64),
and falling losses; the forwards' float32 parity under PyTorch's default
TF32 flags; an EfficientNet-B0 ``Detector.detect`` on the card against its
CPU run; the folded CRAFT on two row strips of the card, and the B0 CRAFT
on two and four, against the whole forward; the conv kernel's bfloat16
mode against its plain bf16 version, the bfloat16 CRAFT (VGG, folded, B0) and CRNN on the card against their
CPU runs, and the bfloat16 golden pipeline live and exported.

Skipped where no CUDA device is present. On a machine with a card and no
JAX, run with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository's conftest imports JAX). The file imports nothing of JAX.
"""

import os

import numpy as np
import pytest
import torch

from keras_ocr_tpu_torch import load_exported, tools
from keras_ocr_tpu_torch.models import CRAFT, init_parameters
from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
from keras_ocr_tpu_torch.ops import cc, cc_cuda, conv_cuda
from keras_ocr_tpu_torch.utils import golden

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(batch, height, width, seed):
    rng = np.random.RandomState(seed)
    fg = np.stack([rng.rand(height, width) < d for d in np.linspace(0.3, 0.8, batch)])
    sentinel = height * width
    values = np.where(fg, np.arange(sentinel).reshape(height, width), sentinel)
    return (
        torch.from_numpy(values.astype(np.int32)),
        torch.from_numpy((~fg).astype(np.int32)),
        sentinel,
    )


@pytest.mark.parametrize("shape", [(3, 17, 29), (2, 96, 160), (1, 5, 2500), (2, 300, 7)])
@pytest.mark.parametrize("sweeps", [0, 1, 8])
def test_kernel_equals_plain(device, shape, sweeps):
    values, barrier, sentinel = _inputs(*shape, seed=sum(shape))
    ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True)
    before = cc_cuda.segmented_min_sweeps.launches
    out, conv = cc_cuda.segmented_min_sweeps(
        values.to(device), barrier.to(device), sentinel, sweeps, True
    )
    torch.cuda.synchronize()
    assert cc_cuda.segmented_min_sweeps.launches == before + 1
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(conv.cpu(), ref_conv)


@pytest.mark.parametrize("shape", [(3, 17, 29), (2, 96, 160), (1, 5, 2500), (2, 300, 7)])
def test_keyed_kernel_equals_plain(device, shape):
    values, barrier, sentinel = _inputs(*shape, seed=sum(shape) + 1)
    fg = barrier == 0
    rng = np.random.RandomState(shape[1])
    key = torch.from_numpy(rng.randint(0, 3, size=shape).astype(np.int32))
    key = torch.where(fg, key, -1)
    ref = cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel)
    before = cc_cuda.keyed_rows_cols.launches
    out = cc_cuda.keyed_rows_cols(values.to(device), key.to(device), fg.to(device), sentinel)
    torch.cuda.synchronize()
    assert cc_cuda.keyed_rows_cols.launches == before + 1
    assert torch.equal(out.cpu(), ref)
    labels = cc.label_blobs_keyed(fg.to(device), key.to(device), num_sweeps=4)
    assert torch.equal(labels.cpu(), cc.label_blobs_keyed(fg, key, num_sweeps=4))


def _serpentine(height, width):
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def _converging_at_different_sweeps(height, width, seed):
    """Empty, one pixel, random at densities 0.3 and 0.7, and a serpentine:
    images that reach their fixpoint at different sweeps (or not at all)."""
    rng = np.random.RandomState(seed)
    single = np.zeros((height, width), bool)
    single[height // 2, width // 2] = True
    fg = np.stack([np.zeros((height, width), bool), single, rng.rand(height, width) < 0.3,
                   rng.rand(height, width) < 0.7, _serpentine(height, width)])
    sentinel = height * width
    values = np.where(fg, np.arange(sentinel).reshape(height, width), sentinel)
    return torch.from_numpy(values.astype(np.int32)), torch.from_numpy(fg), sentinel


# Widths that are not a multiple of the 32-column band, a map taller than
# one 32-column band of shared memory, a row at the 4096-cell line limit,
# and the main path's heatmap size.
ODD_SHAPES = [(300, 7), (17, 29), (2000, 40), (5, 4096), (96, 160), (480, 640)]
BARRIER_TYPES = [torch.bool, torch.uint8, torch.int32]


@pytest.mark.parametrize("dtype", BARRIER_TYPES, ids=str)
@pytest.mark.parametrize("sweeps", [0, 1, 8, 20])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_kernel_stops_each_image_at_its_fixpoint(device, shape, sweeps, dtype):
    values, fg, sentinel = _converging_at_different_sweeps(*shape, seed=sum(shape))
    barrier = (~fg).to(dtype)
    ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True)
    out, conv = cc_cuda.segmented_min_sweeps(
        values.to(device), barrier.to(device), sentinel, sweeps, True
    )
    plain = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps)
    unchecked = cc_cuda.segmented_min_sweeps(values.to(device), barrier.to(device), sentinel, sweeps)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(conv.cpu(), ref_conv)
    assert torch.equal(unchecked.cpu(), plain)
    assert bool(conv[0]) and bool(conv[1])


@pytest.mark.parametrize("dtype", BARRIER_TYPES, ids=str)
@pytest.mark.parametrize("shape", ODD_SHAPES[:4])
def test_keyed_kernel_equals_plain_at_odd_shapes(device, shape, dtype):
    values, fg, sentinel = _converging_at_different_sweeps(*shape, seed=sum(shape) + 2)
    rng = np.random.RandomState(shape[0])
    key = torch.from_numpy(rng.randint(0, 3, size=fg.shape).astype(np.int32))
    key = torch.where(fg, key, -1)
    ref = cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel)
    out = cc_cuda.keyed_rows_cols(
        values.to(device), key.to(device), fg.to(dtype).to(device), sentinel
    )
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)


def test_kernel_leaves_its_input_alone_and_labels_on_device(device):
    values, barrier, sentinel = _inputs(2, 64, 96, seed=0)
    dev_values = values.to(device)
    out = cc_cuda.segmented_min_sweeps(dev_values, barrier.to(device), sentinel, 4)
    assert torch.equal(dev_values.cpu(), values)
    assert out.device.type == "cuda"
    fg = barrier == 0
    labels = cc.label_components(fg.to(device), num_sweeps=8)
    assert torch.equal(labels.cpu(), cc.label_components(fg, num_sweeps=8))


def test_kernel_rejects_what_it_cannot_take(device):
    values, barrier, sentinel = _inputs(1, 8, 8, seed=0)
    with pytest.raises(TypeError):
        cc_cuda.segmented_min_sweeps(
            values.to(device, torch.int64), barrier.to(device), sentinel, 1
        )
    with pytest.raises(ValueError):
        cc_cuda.segmented_min_sweeps(values.to(device), barrier, sentinel, 1)
    with pytest.raises(ValueError):
        cc_cuda.segmented_min_sweeps(values.to(device), barrier[:, :4].to(device), sentinel, 1)
    with pytest.raises(TypeError):
        cc_cuda.segmented_min_sweeps(
            values.to(device), barrier.to(device, torch.float32), sentinel, 1
        )
    fg = (barrier == 0).to(device)
    with pytest.raises(ValueError):
        cc_cuda.keyed_rows_cols(values.to(device), values.to(device), fg.cpu(), sentinel)
    with pytest.raises(ValueError):
        cc_cuda.keyed_rows_cols(values.to(device), values.to(device), fg[:, 1:], sentinel)
    # Images ride on the grid's y dimension: at most 65535 of them.
    many = torch.zeros((65536, 1, 1), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="batch limit 65535"):
        cc_cuda.segmented_min_sweeps(many, many == 0, 0, 1)
    with pytest.raises(ValueError, match="batch limit 65535"):
        cc_cuda.keyed_rows_cols(many, many, many == 0, 0)


@pytest.fixture
def full_fp32():
    """cuDNN and matmul in full fp32 (the conv bars assume TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _chain(batch, height, width, cin, plan, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, height, width, cin).astype(np.float32))
    convs = []
    for k, cout, relu in plan:
        w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
        b = (0.1 * rng.randn(cout)).astype(np.float32)
        convs.append((torch.from_numpy(w), torch.from_numpy(b), relu))
        cin = cout
    return x, convs


def _assert_close(out, ref):
    assert out.device.type == "cuda" and out.shape == ref.shape
    bar = 1e-4 * max(1.0, float(ref.abs().max()))
    assert float((out.cpu() - ref).abs().max()) <= bar


# Awkward shapes: Cin 3, Cout 2, odd H and W (floored pool, full tap), B = 3,
# channel counts that are not multiples of 4, more than one column tile;
# the golden slim widths (16-128) and CRAFT's deepest K (1536 in a 1x1,
# 4608 in a 3x3) at small spatial sizes; a batch-2 pooled chain at an odd
# size with the tap.
CHAIN_CASES = [
    (3, 13, 37, 3, [(3, 16, True), (3, 16, True)], True, True),
    (3, 17, 9, 5, [(3, 6, True), (1, 7, True), (3, 2, False)], False, False),
    (2, 11, 15, 16, [(1, 32, True), (3, 130, True)], True, False),
    (1, 24, 40, 32, [(3, 32, True), (3, 32, True), (3, 16, True), (1, 16, True),
                     (1, 2, False)], False, False),
    (2, 9, 13, 8, [(3, 8, False)], True, True),
    (1, 5, 8, 4, [(1, 4, True)], True, True),
    (1, 48, 64, 3, [(3, 16, True), (3, 16, True)], True, False),
    (1, 24, 32, 16, [(3, 32, True), (3, 32, True)], True, True),
    (1, 12, 16, 32, [(3, 64, True), (3, 64, True)], False, False),
    (1, 12, 16, 64, [(3, 64, True)], True, False),
    (1, 6, 8, 128, [(3, 128, True), (3, 128, False)], False, False),
    (1, 6, 8, 384, [(1, 64, True), (3, 32, True)], False, False),
    (1, 8, 10, 1536, [(1, 512, True)], False, False),
    (1, 8, 10, 512, [(3, 512, True)], False, False),
    (2, 15, 21, 8, [(3, 32, True), (3, 64, True)], True, True),
]


@pytest.mark.parametrize("batch,height,width,cin,plan,pool,tap", CHAIN_CASES)
def test_conv_chain_kernel_equals_plain(device, full_fp32, batch, height, width, cin,
                                        plan, pool, tap):
    x, convs = _chain(batch, height, width, cin, plan, seed=height * width)
    ref = conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)
    on_card = [(w.to(device), b.to(device), relu) for w, b, relu in convs]
    chains, convs3 = conv_cuda.conv_chain.launches, conv_cuda.conv3x3_bias_act.launches
    out = conv_cuda.conv_chain(x.to(device), on_card, pool=pool, tap_prepool=tap)
    torch.cuda.synchronize()
    assert conv_cuda.conv_chain.launches == chains + 1
    unpooled_3x3 = sum(w.shape[0] == 3 for w, _, _ in convs[: len(convs) - pool])
    assert conv_cuda.conv3x3_bias_act.launches == convs3 + unpooled_3x3
    for got, want in zip(out, ref) if tap else [(out, ref)]:
        _assert_close(got, want)


@pytest.mark.parametrize("shape", [(3, 13, 37, 3, 16), (1, 24, 40, 8, 2), (2, 6, 260, 5, 131)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel_equals_plain(device, full_fp32, shape, relu):
    batch, height, width, cin, cout = shape
    x, ((w, b, _),) = _chain(batch, height, width, cin, [(3, cout, relu)], seed=cout)
    ref = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=relu)
    before = conv_cuda.conv3x3_bias_act.launches
    out = conv_cuda.conv3x3_bias_act(x.to(device), w.to(device), b.to(device), relu=relu)
    torch.cuda.synchronize()
    assert conv_cuda.conv3x3_bias_act.launches == before + 1
    _assert_close(out, ref)
    single = conv_cuda.conv3x3_bias_act(x[0].to(device), w.to(device), b.to(device), relu=relu)
    _assert_close(single, ref[0])


def _assert_bf16_chain(out, ref, layers):
    """The bf16 mode's bars: one ulp (:func:`conv_cuda.bf16_ulps`) for a
    single layer; for a chain 1.6e-2 x max(1, max|ref|) and 99% of the
    values within one ulp (a rounding of one layer can move the next)."""
    assert out.device.type == "cuda" and out.dtype == ref.dtype == torch.bfloat16
    assert out.shape == ref.shape
    ulps = conv_cuda.bf16_ulps(out.cpu(), ref)
    if layers == 1:
        assert float(ulps.max()) <= 1.0
    else:
        assert float((out.cpu().float() - ref.float()).abs().max()) <= 1.6e-2 * max(
            1.0, float(ref.float().abs().max()))
        assert float((ulps <= 1.0).float().mean()) >= 0.99


@pytest.mark.parametrize("batch,height,width,cin,plan,pool,tap", CHAIN_CASES)
def test_conv_chain_kernel_bf16_equals_plain(device, full_fp32, batch, height, width, cin,
                                             plan, pool, tap):
    """The bf16 mode (bf16 input, float32 weights and bias cast inside)
    against the plain bf16 chain: float32 conv of the rounded operands, one
    rounding per layer."""
    x, convs = _chain(batch, height, width, cin, plan, seed=height * width)
    x = x.to(torch.bfloat16)
    ref = conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)
    on_card = [(w.to(device), b.to(device), relu) for w, b, relu in convs]
    chains, convs3 = conv_cuda.conv_chain.launches, conv_cuda.conv3x3_bias_act.launches
    out = conv_cuda.conv_chain(x.to(device), on_card, pool=pool, tap_prepool=tap)
    torch.cuda.synchronize()
    assert conv_cuda.conv_chain.launches == chains + 1
    unpooled_3x3 = sum(w.shape[0] == 3 for w, _, _ in convs[: len(convs) - pool])
    assert conv_cuda.conv3x3_bias_act.launches == convs3 + unpooled_3x3
    for got, want in zip(out, ref) if tap else [(out, ref)]:
        _assert_bf16_chain(got, want, len(plan))


@pytest.mark.parametrize("shape", [(3, 13, 37, 3, 16), (1, 24, 40, 8, 2), (2, 6, 260, 5, 131),
                                   (1, 60, 80, 256, 256)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel_bf16_equals_plain(device, full_fp32, shape, relu):
    batch, height, width, cin, cout = shape
    x, ((w, b, _),) = _chain(batch, height, width, cin, [(3, cout, relu)], seed=cout)
    x = x.to(torch.bfloat16)
    ref = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=relu)
    before = conv_cuda.conv3x3_bias_act.launches
    out = conv_cuda.conv3x3_bias_act(x.to(device), w.to(device), b.to(device), relu=relu)
    torch.cuda.synchronize()
    assert conv_cuda.conv3x3_bias_act.launches == before + 1
    _assert_bf16_chain(out, ref, 1)


def test_conv_chain_takes_views(device, full_fp32):
    """A channel slice (non-contiguous, starting 4 bytes into the storage)
    and an unaligned contiguous view: the wrapper copies what TMA cannot
    take."""
    x, convs = _chain(2, 9, 19, 8, [(3, 12, True), (1, 8, True)], seed=7)
    on_card = [(w.to(device), b.to(device), relu) for w, b, relu in convs]
    wide = torch.cat([torch.ones_like(x[..., :1]), x], -1).to(device)
    view = wide[..., 1:]
    flat = torch.cat([torch.ones(1), x.flatten()]).to(device)[1:].view(x.shape)
    assert not view.is_contiguous() and flat.data_ptr() % 16 != 0
    ref = conv_cuda.conv_chain_plain(x, convs, pool=True, tap_prepool=True)
    for given in (view, flat):
        out = conv_cuda.conv_chain(given, on_card, pool=True, tap_prepool=True)
        torch.cuda.synchronize()
        for got, want in zip(out, ref):
            _assert_close(got, want)


def test_conv_kernels_reject_what_they_cannot_take(device):
    x, ((w, b, relu),) = _chain(1, 8, 8, 4, [(3, 8, True)], seed=0)
    x, w, b = x.to(device), w.to(device), b.to(device)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError):
            conv_cuda.conv3x3_bias_act(x.to(dtype), w.to(dtype), b.to(dtype))
        with pytest.raises(TypeError):
            conv_cuda.conv_chain(x.to(dtype), [(w.to(dtype), b.to(dtype), relu)])
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_bias_act(x, w.cpu(), b)
    with pytest.raises(ValueError):
        conv_cuda.conv_chain(x, [(w.cpu(), b, relu)])


def _bf16_launch(device, x, w, b, relu=True, pool=False, tap=False, bn=None, slab=None,
                 sms=None):
    """One launch of the bf16 kernel straight through ``conv_layer_bf16`` on
    the operands the wrapper makes, at a chosen Cout tile, K slab and grid
    (by default the wrapper's), into outputs filled with NaN first; returns
    (out, tap) on the CPU."""
    x, w, b = x.to(torch.bfloat16).to(device), w.to(device), b.to(device)
    batch, height, width, _ = x.shape
    cout = w.shape[3]
    xk, wmat, k, cin_pad = conv_cuda.kernel_operands(x, w)
    sms = sms or torch.cuda.get_device_properties(device).multi_processor_count
    bn = bn or conv_cuda.tile_n(cout, conv_cuda.tiles_m(batch, height, width), torch.bfloat16,
                                sms)
    slab = slab or conv_cuda.slab_channels(cin_pad, torch.bfloat16)
    out_hw = (height // 2, width // 2) if pool else (height, width)
    out = torch.full((batch, *out_hw, cout), float("nan"), dtype=torch.bfloat16, device=device)
    tap_out = torch.full((batch, height, width, cout), float("nan"), dtype=torch.bfloat16,
                         device=device) if tap else None
    rc = conv_cuda._library().conv_layer_bf16(
        xk.data_ptr(), wmat.data_ptr(), b.data_ptr(), out.data_ptr(),
        tap_out.data_ptr() if tap else None, batch, height, width, cin_pad, cout, k, int(relu),
        int(pool), bn, slab, sms, torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    return out.cpu(), tap_out.cpu() if tap else None


def _assert_bf16_layer(x, w, b, relu, pool, tap, got):
    """A launch's outputs: every cell written (no NaN left of the fill)
    and within one bf16 ulp of the plain layer."""
    ref = conv_cuda.conv_chain_plain(x.to(torch.bfloat16), [(w, b, relu)], pool=pool,
                                     tap_prepool=tap)
    for out, want in zip(got, ref) if tap else [(got[0], ref)]:
        assert not torch.isnan(out.float()).any()
        _assert_bf16_chain(out.to("cuda"), want, 1)


# (batch, height, width, cin, k, cout, pool, tap): grids of many tiles a
# persistent block with a ragged last round, Cout tiles of 256 with a
# remainder, C1's first layer (Cin 3, the im2col) across tile edges in both
# directions, the cls head's Cin-16/32 layers, pooled layers with the tap at
# odd sizes.
BF16_LAYERS = [
    (2, 200, 328, 64, 3, 128, False, False),
    (3, 61, 83, 256, 3, 260, False, False),
    (1, 33, 47, 512, 1, 512, False, False),
    (2, 37, 53, 3, 3, 64, False, False),
    (1, 120, 161, 3, 3, 64, False, False),
    (2, 45, 70, 32, 3, 32, False, False),
    (2, 45, 70, 32, 3, 16, False, False),
    (2, 45, 70, 16, 1, 16, False, False),
    (2, 45, 70, 16, 1, 2, False, False),
    (2, 25, 39, 64, 3, 128, True, True),
    (1, 17, 33, 8, 3, 256, True, True),
    (3, 9, 13, 3, 3, 64, True, True),
]


@pytest.mark.parametrize("batch,height,width,cin,k,cout,pool,tap", BF16_LAYERS)
@pytest.mark.parametrize("grid", ["wrapper", "bn256_7_sms", "slab64_7_sms"])
def test_bf16_persistent_kernel_writes_every_cell(device, full_fp32, batch, height, width, cin,
                                                  k, cout, pool, tap, grid):
    """The persistent bf16 kernel at the wrapper's Cout tile, K slab and
    grid, and forced to 256-wide tiles or 64-channel slabs on a grid of 7
    blocks (many tiles a block, a ragged last round), its outputs poisoned
    with NaN first: every cell written, one ulp from the plain layer."""
    x, ((w, b, relu),) = _chain(batch, height, width, cin, [(k, cout, True)], seed=cout + cin)
    options = {"wrapper": {}, "bn256_7_sms": {"bn": 256, "sms": 7},
               "slab64_7_sms": {"slab": 64, "sms": 7}}[grid]
    got = _bf16_launch(device, x, w, b, relu, pool, tap, **options)
    _assert_bf16_layer(x, w, b, relu, pool, tap, got)


def test_bf16_im2col_kernel_equals_plain(device):
    """C1's first layer runs as a 1x1 layer on its im2col: the
    ``conv_im2col_bf16`` kernel's columns equal the plain ``im2col`` bit for
    bit, for Cin 1-3 across tile edges."""
    for cin, shape in ((3, (2, 37, 53)), (2, (1, 9, 130)), (1, (3, 17, 16))):
        x = torch.randn((*shape, cin), generator=torch.Generator().manual_seed(cin))
        x = x.to(torch.bfloat16)
        got = conv_cuda._im2col_cuda(x.to(device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), conv_cuda.im2col(x))


def test_bf16_folded_craft_follows_in_place_updates(device):
    """The folded bf16 CRAFT keeps its kernel operands between forwards
    and makes them anew after an in-place update of its parameters: the
    second forward equals a freshly built model's with the updated
    weights, bit for bit, and differs from the first."""
    model = init_parameters(CRAFT(width=0.25, fold_bn=True, dtype=torch.bfloat16), seed=0)
    model = model.to(device).eval()
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 64, 96, 3).astype(np.float32))
    x = x.to(device)
    with torch.inference_mode():
        first = model(x)
        again = model(x)
    assert torch.equal(first, again)
    with torch.no_grad():
        for name, parameter in model.named_parameters():
            if name.endswith("conv.weight") or name.startswith("conv_cls"):
                parameter.mul_(1.25)
    fresh = CRAFT(width=0.25, fold_bn=True, dtype=torch.bfloat16).to(device).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        second, want = model(x), fresh(x)
    assert torch.equal(second, want)
    assert not torch.equal(second, first)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 72, 104)])
def test_folded_craft_on_card_matches_unfolded(device, full_fp32, shape):
    """The BN-folded graph (conv kernel) against the standard one (cuDNN),
    with non-trivial BatchNorm statistics; (1, 72, 104) reaches the odd
    pool at slice4_30."""
    model = init_parameters(CRAFT(width=0.25), seed=0)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                n = module.num_features
                module.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                module.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, n)))
                module.running_mean.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, n)))
                module.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n)))
    folded = CRAFT(width=0.25, fold_bn=True)
    folded.load_state_dict(fold_bn_state_dict(model.state_dict()))
    model, folded = model.to(device).eval(), folded.to(device).eval()
    x = torch.from_numpy(rng.randn(*shape, 3).astype(np.float32)).to(device)
    chains = conv_cuda.conv_chain.launches
    with torch.inference_mode():
        out, ref = folded(x), model(x)
    torch.cuda.synchronize()
    assert conv_cuda.conv_chain.launches == chains + 12
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 2)
    bar = 1e-4 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= bar


def test_folded_strips_on_card_launch_the_kernel_and_match(device, full_fp32):
    """Spatial sharding on one card: the BN-folded CRAFT on two row strips
    of ``[cuda, cuda]`` (``parallel/halo.py``; 136 rows, so the decoder's
    first resize is not 2x) launches the conv kernel for all 12 chains of
    each strip, and the heatmaps equal the unsharded forward's within
    1e-4 x max(1, max|ref|)."""
    from keras_ocr_tpu_torch.parallel import halo

    model = init_parameters(CRAFT(width=0.25), seed=0)
    folded = CRAFT(width=0.25, fold_bn=True)
    folded.load_state_dict(fold_bn_state_dict(model.state_dict()))
    folded = folded.to(device).eval()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 136, 200, 3).astype(np.float32)).to(device)
    with torch.inference_mode():
        ref = folded(x)
        chains = conv_cuda.conv_chain.launches
        out = halo.StripForward([device, device])([folded, folded], x)
    torch.cuda.synchronize()
    assert conv_cuda.conv_chain.launches == chains + 24
    assert out.shape == ref.shape == (2, 68, 100, 2)
    assert float((out - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("height,parts", [(136, 2), (135, 4)])
def test_b0_strips_on_card_match(device, full_fp32, height, parts):
    """Spatial sharding of an EfficientNet CRAFT on one card: B0 on row
    strips of ``[cuda] * parts`` (halo rows for the depthwise convs, the
    whole image's pads for the strided ones, whole-image squeeze-excite
    means; an odd height on 4 strips) against the whole forward within
    1e-4 x max(1, max|ref|)."""
    from keras_ocr_tpu_torch.parallel import halo

    model = init_parameters(CRAFT("efficientnetb0"), seed=0).to(device).eval()
    x = torch.from_numpy(np.random.RandomState(height).randn(2, height, 200, 3)
                         .astype(np.float32)).to(device)
    with torch.inference_mode():
        ref = model(x)
        out = halo.StripForward([device] * parts)([model] * parts, x)
    assert out.shape == ref.shape == (2, -(-height // 2), 100, 2)
    assert float((out - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


# The window batches of the refine ladder on (8, 480, 640) heatmaps, as
# (maps, height, width), and odd small windows.
WINDOW_BATCHES = [(64, 128, 512), (8, 512, 640), (32, 480, 640), (3, 17, 29), (5, 5, 300),
                  (2, 300, 7)]


def _windows(maps, height, width, seed):
    """Seeded blob planes: a few filled rectangles with holes, and noise at
    the percolation density in the last map."""
    rng = np.random.RandomState(seed)
    fg = np.zeros((maps, height, width), bool)
    for m in range(maps):
        for _ in range(4):
            y, x = rng.randint(0, height), rng.randint(0, width)
            h, w = rng.randint(1, height // 2 + 2), rng.randint(1, width // 2 + 2)
            fg[m, y : y + h, x : x + w] = True
            fg[m, y + h // 3 : y + 2 * h // 3, x + w // 3 : x + 2 * w // 3] = False
    fg[-1] = rng.rand(height, width) < 0.6
    return torch.from_numpy(fg)


@pytest.mark.parametrize("num_iters", [1, 16])
@pytest.mark.parametrize("shape", WINDOW_BATCHES)
def test_refine_labelling_and_flood_equal_plain(device, monkeypatch, shape, num_iters):
    """``label_components_8conn`` and ``flood_from_seeds`` through the
    kernel equal the same calls through the plain sweeps, on the card,
    converged flags included."""
    fg = _windows(*shape, seed=sum(shape)).to(device)
    border = torch.zeros(shape[1:], dtype=torch.bool, device=device)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    bg = ~fg

    def run():
        label = cc.label_components_8conn(fg, num_iters, check_convergence=True)
        flood = cc.flood_from_seeds(bg, bg & border, num_iters, check_convergence=True)
        return label + flood

    before = cc_cuda.segmented_min_sweeps.launches
    out = run()
    assert cc_cuda.segmented_min_sweeps.launches == before + num_iters + 2
    monkeypatch.setattr(cc, "segmented_min_sweeps", cc_cuda.segmented_min_sweeps_plain)
    ref = run()
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


def _split_words(rng, height=96, width=128, words=3):
    """Words whose overlap-removed segmap splits into islands that the
    dilation does not re-merge (as ``tests/test_refine.py`` builds them)."""
    text = np.zeros((height, width), "float32")
    link = np.zeros((height, width), "float32")
    for _ in range(words):
        y, x, gap = rng.randint(10, height - 14), rng.randint(8, width - 60), rng.randint(14, 30)
        text[y : y + 6, x : x + 7] = 0.95
        text[y : y + 6, x + 7 + gap : x + 14 + gap] = 0.9
        text[y + 2 : y + 4, x + 7 : x + 7 + gap] = 0.45
        link[y + 2 : y + 4, x + 6 : x + 8 + gap] = 0.5
    return np.stack([text, link], -1)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_refine_boxes_on_card_equal_cpu(device, level):
    from keras_ocr_tpu_torch.ops import postprocess, refine

    hm = torch.from_numpy(np.stack([_split_words(np.random.RandomState(s)) for s in range(4)]))
    wh, ww, md, it, rc = refine.LADDER[level]
    settings = dict(max_components=16, refine_cap=rc, window_h=wh, window_w=ww, max_dilate=md,
                    num_iters=it)
    results = []
    for maps in (hm, hm.to(device)):
        boxes, _, _ = postprocess.get_boxes(maps, max_components=16)
        results.append([t.cpu() for t in refine.refine_boxes(maps, boxes, **settings)])
    (boxes, ok, n), (ref_boxes, ref_ok, ref_n) = results[1], results[0]
    assert torch.equal(ok, ref_ok) and torch.equal(n, ref_n)
    assert bool(ok.all()) and int(n.min()) >= 1
    assert float((boxes - ref_boxes).abs().max()) <= 1e-3


def _op_cases(device):
    rng = np.random.RandomState(0)
    fg = torch.from_numpy(rng.rand(3, 9, 13) < 0.6).to(device)
    sentinel = 9 * 13
    index = torch.arange(sentinel, dtype=torch.int32, device=device).reshape(9, 13)
    values = torch.where(fg, index, torch.full_like(index, sentinel))
    key = torch.from_numpy(rng.randint(0, 3, size=(3, 9, 13))).to(device, torch.int32)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((2, 7, 9, 5), generator=gen, device=device)
    w3 = torch.randn((3, 3, 5, 6), generator=gen, device=device) / 9
    w1 = torch.randn((1, 1, 5, 6), generator=gen, device=device) / 3
    b = 0.1 * torch.randn((6,), generator=gen, device=device)
    ops = torch.ops.keras_ocr_tpu_torch
    return {
        "cc_sweeps": (ops.cc_sweeps.default, (values, ~fg, sentinel, 4, False)),
        "cc_sweeps_check": (ops.cc_sweeps.default, (values, ~fg, sentinel, 4, True)),
        "cc_keyed_rows_cols": (ops.cc_keyed_rows_cols.default, (values, key, fg, sentinel)),
        "conv_layer_3x3": (ops.conv_layer.default, (x, w3, b, True, False, False, True)),
        "conv_layer_1x1_pool_tap": (ops.conv_layer.default, (x, w1, b, True, True, True, False)),
    }


@pytest.mark.parametrize("case", ["cc_sweeps", "cc_sweeps_check", "cc_keyed_rows_cols",
                                  "conv_layer_3x3", "conv_layer_1x1_pool_tap"])
def test_ops_pass_opcheck_on_card(device, full_fp32, case):
    op, args = _op_cases(device)[case]
    torch.library.opcheck(op, args)


GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline")


@pytest.mark.parametrize("fold_bn", [False, True], ids=["standard", "folded"])
def test_exported_golden_on_card_equals_live(device, full_fp32, tmp_path, fold_bn):
    """The golden pipeline exported on the card, loaded and run: its packed
    output equals the live device program's at the baked levels bit for
    bit, and the launch counters advance during the artifact's run (the
    counts live in the ops' CUDA kernels): 20 label-sweep calls (2 of
    ``get_boxes``, 18 of refine level 1) and 8 keyed calls, and on the
    folded graph 12 chains with 15 unpooled 3x3 layers."""
    pipeline, meta = golden.load_golden_pipeline(GOLDEN, device=device, fold_bn=fold_bn)
    height, width = meta["pad_to"]
    path = str(tmp_path / "golden")
    pipeline.export(path, height=height, width=width, batch_size=2)
    served = load_exported(path)
    images = [tools.read(os.path.join(GOLDEN, f"scene_0{i}.png")) for i in range(2)]
    batch = torch.from_numpy(
        np.stack([tools.pad(image, width=width, height=height) for image in images])
    ).to(device)
    wrappers = [cc_cuda.segmented_min_sweeps, cc_cuda.keyed_rows_cols, conv_cuda.conv_chain,
                conv_cuda.conv3x3_bias_act]
    before = [wrapper.launches for wrapper in wrappers]
    with torch.inference_mode():
        packed = served._program(batch)
    torch.cuda.synchronize()
    launched = [wrapper.launches - count for wrapper, count in zip(wrappers, before)]
    assert launched == [20, 8] + ([12, 15] if fold_bn else [0, 0])
    live = pipeline._device_pipeline(
        batch, 0.7, 0.4, 0.4, 10.0, pipeline.detector.max_components, pipeline.max_words,
        resize_to=(height * meta["scale"], width * meta["scale"]),
        refine_level=served.meta["refine_level"], warp_level=served.meta["warp_level"],
    )
    assert packed.device.type == "cuda"
    assert torch.equal(packed, live)
    words = [[w for w, _ in r] for r in served.recognize(images)]
    assert words == [[w for w, _ in r] for r in pipeline.recognize(images)]


def _gradient_leaves(model, bridge):
    state = dict(model.state_dict())
    for name, param in model.named_parameters():
        state[name] = param.grad if param.grad is not None else torch.zeros_like(param)

    def leaves(tree, prefix=""):
        for key, value in sorted(tree.items()):
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", np.asarray(value)

    return dict(leaves(bridge(state)["params"]))


def _gradient_errors(model, reference, bridge):
    """(worst max|g - g_ref| / max|g_ref| over the leaves, the largest |g|
    of the leaves that are rounding noise in the reference, over its
    largest)."""
    ours, ref = _gradient_leaves(model, bridge), _gradient_leaves(reference, bridge)
    largest = max(np.abs(value).max() for value in ref.values())
    worst = noise = 0.0
    for path, value in ref.items():
        scale = np.abs(value).max()
        if scale <= 1e-9 * largest:
            noise = max(noise, np.abs(ours[path]).max() / largest)
        else:
            worst = max(worst, np.abs(ours[path] - value).max() / scale)
    return worst, noise


def _step_on_card_and_cpu(trainer_cls, model_on, bridge, batch, **kwargs):
    """One train step from one state on the card and on the CPU, in
    float32 and in float64: the float32 losses within 1e-4 relative; each
    float64 gradient leaf within 1e-3 of its largest |g| (leaves that are
    rounding noise on the CPU below 1e-4 of the largest gradient). The
    float32 gradients are not compared: the card's cuDNN and CUDA
    reductions leave them up to ~5e-3 (CRNN) and ~6e-2 (CRAFT at random
    init, where the CPU's own float32 step is 4.5e-2 off) from the float64
    ones. Returns the float32 card trainer and its loss."""
    card = model_on("cuda")
    variables = bridge(card.model)
    cpu, card64, cpu64 = (model_on(on).load_variables(variables) for on in ("cpu", "cuda", "cpu"))
    for wide in (card64, cpu64):
        wide.model.double()
    trainer = trainer_cls(card, **kwargs)
    loss = trainer.train_step(batch)
    assert abs(loss - trainer_cls(cpu, **kwargs).train_step(batch)) <= 1e-4 * abs(loss)
    trainer_cls(card64, **kwargs).train_step(batch)
    trainer_cls(cpu64, **kwargs).train_step(batch)
    worst, noise = _gradient_errors(card64.model, cpu64.model, bridge)
    assert worst <= 1e-3 and noise <= 1e-4, (worst, noise)
    return trainer, loss


def test_crnn_train_step_on_card_matches_cpu(device, full_fp32):
    """The full-width CRNN (dropout 0, STN at its identity start) at batch
    8; 20 RMSprop steps on the batch lower the loss."""
    from keras_ocr_tpu_torch import Recognizer, weights
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS
    from keras_ocr_tpu_torch.train import RecognizerTrainer

    params = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)
    rng = np.random.RandomState(11)
    frames = 48
    label_length = rng.randint(1, 21, size=(8, 1))
    labels = np.full((8, frames), -1)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, 36, size=n)
    batch = ((rng.rand(8, 31, 200, 1).astype(np.float32), labels,
              np.full((8, 1), frames), label_length), np.zeros((8, 1)))
    trainer, first = _step_on_card_and_cpu(
        RecognizerTrainer,
        lambda on: Recognizer(weights=None, build_params=params, device=on, seed=3),
        weights.crnn_variables, batch)
    losses = [first] + [trainer.train_step(batch) for _ in range(19)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert not trainer.model.training


@pytest.mark.parametrize("loss", ["mse", "ohem"])
def test_craft_train_step_on_card_matches_cpu(device, full_fp32, loss):
    """CRAFT at width 1.0, 2x256x256, under both losses; 20 Adam steps on
    the batch lower the loss."""
    from keras_ocr_tpu_torch import Detector, weights
    from keras_ocr_tpu_torch.train import DetectorTrainer

    rng = np.random.RandomState(12)
    images = rng.randn(2, 256, 256, 3).astype(np.float32)
    targets = (rng.rand(2, 128, 128, 2) * 0.05).astype(np.float32)
    targets[:, 20:40, 10:70, 0] = 0.9
    targets[:, 26:34, 10:70, 1] = 0.6
    trainer, first = _step_on_card_and_cpu(
        DetectorTrainer, lambda on: Detector(weights=None, width=1.0, device=on, seed=4),
        weights.craft_variables, (images, targets), loss=loss)
    losses = [first] + [trainer.train_step((images, targets)) for _ in range(19)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_forwards_hold_parity_under_pytorch_defaults(device):
    """No ``full_fp32`` fixture: PyTorch's defaults let cuDNN use TF32,
    which moved the full-width VGG16-BN CRAFT's heatmaps 3.2e-4 from float32
    (``scripts/tf32_parity.py``). The port's forwards run in full float32
    whatever the flags say: the full-width VGG and EfficientNet-B0 CRAFT
    heatmaps and the CRNN's softmax under the defaults (and with TF32 on
    for matmuls too) equal those under TF32 off within 1e-4 *
    max(1, max|ref|); the caller's flags read as before afterwards; the
    golden artifact passes under the defaults."""
    from keras_ocr_tpu_torch import Recognizer

    rng = np.random.RandomState(14)
    models = []
    for name in ("vgg", "efficientnetb0"):
        model = init_parameters(CRAFT(name), seed=0).to(device).eval()
        models.append((model, torch.from_numpy(rng.randn(1, 960, 1280, 3).astype(np.float32))))
    crnn = Recognizer(weights=None, device=device, seed=1).model
    models.append((crnn, torch.from_numpy(rng.rand(16, 31, 200, 1).astype(np.float32))))
    flags = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    outputs = {}
    with torch.inference_mode():
        for label, setting in (("defaults", None), ("all tf32", (True, "high")),
                               ("off", (False, "highest"))):
            if setting is not None:
                torch.backends.cudnn.allow_tf32 = setting[0]
                torch.set_float32_matmul_precision(setting[1])
            try:
                outputs[label] = [model(x.to(device)) for model, x in models]
                assert (torch.backends.cudnn.allow_tf32,
                        torch.get_float32_matmul_precision()) == (setting or flags)
            finally:
                torch.backends.cudnn.allow_tf32 = flags[0]
                torch.set_float32_matmul_precision(flags[1])
    for label in ("defaults", "all tf32"):
        for out, ref in zip(outputs[label], outputs["off"]):
            bar = 1e-4 * max(1.0, float(ref.abs().max()))
            assert float((out - ref).abs().max()) <= bar, label
    result = golden.run_golden_check(
        GOLDEN, pipeline=golden.load_golden_pipeline(GOLDEN, device=device)[0])
    assert result["pass"], result


def test_efficientnet_detect_on_card_matches_cpu(device, tmp_path, monkeypatch):
    """An EfficientNet-B0 ``Detector`` (ImageNet file absent, network
    refused: random backbone) on the card: its heatmaps of 2 golden scenes
    within 1e-4 of the same detector's on the CPU, and ``detect`` on the
    card (both sweep-kernel entries launched) within 1e-3 px of the CPU's
    ``detect`` on the card's heatmaps, at thresholds set by the heatmaps'
    quantiles (random heatmaps near 0.5 form no box at the defaults)."""
    import urllib.request
    import warnings

    from keras_ocr_tpu_torch import Detector, weights
    from keras_ocr_tpu_torch.ops.image import compute_input

    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(tmp_path / "vendored"))
    monkeypatch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the missing ImageNet file
        detectors = {on: Detector(weights=None, backbone_name="efficientnetb0", device=on,
                                  seed=0) for on in ("cpu", device)}
    detectors[device].load_variables(weights.craft_variables(detectors["cpu"].model))
    scenes = [tools.pad(tools.read(os.path.join(GOLDEN, f"scene_0{i}.png")), width=320,
                        height=256) for i in range(2)]
    batch = torch.from_numpy(np.stack(scenes))
    with torch.inference_mode():
        heatmaps = {on: detector.model(compute_input(batch.to(on))).cpu()
                    for on, detector in detectors.items()}
    ref = heatmaps["cpu"]
    assert float((heatmaps[device] - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    hm = heatmaps[device].numpy()
    thresholds = dict(text_threshold=float(np.quantile(hm[..., 0], 0.9)),
                      link_threshold=float(np.quantile(hm[..., 1], 0.95)),
                      detection_threshold=float(np.quantile(hm[..., 0], 0.97)))

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return heatmaps[device].to(x.device)

    before = cc_cuda.segmented_min_sweeps.launches, cc_cuda.keyed_rows_cols.launches
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # detect's forward = the one above
    try:
        found = detectors[device].detect(scenes, **thresholds)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert cc_cuda.segmented_min_sweeps.launches > before[0]
    assert cc_cuda.keyed_rows_cols.launches > before[1]
    detectors["cpu"].model = Fixed()
    expected = detectors["cpu"].detect(scenes, **thresholds)
    assert sum(len(b) for b in expected) > 0
    for got, want in zip(found, expected):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# Every cell of a sweep-kernel output must be written. The kernel returns
# early for an image at its fixpoint and a pass stores only the cells of its
# tile's lines, so a hole in the tiling would leave the wrapper's
# ``torch.empty_like`` memory as it was: here it holds a poison value.
POISON = -1_234_567_891
# (batch, height, width): batch 1-9, odd heights and widths, widths that are
# no multiple of the 8-32-column band, single rows and columns, a map taller
# than a 32-column band holds (711 rows), and the main path's heatmap size.
COVERAGE_SHAPES = [(1, 1, 1), (2, 7, 9), (3, 33, 65), (4, 1, 301), (5, 299, 1),
                   (6, 121, 37), (7, 712, 41), (8, 240, 321), (9, 480, 640)]
COVERAGE_MAPS = ["all_foreground", "all_background", "serpentine", "random"]


def _coverage_maps(kind, batch, height, width):
    rng = np.random.RandomState(batch * 1000 + height + width)
    if kind == "all_foreground":
        fg = np.ones((batch, height, width), bool)
    elif kind == "all_background":
        fg = np.zeros((batch, height, width), bool)
    elif kind == "serpentine":
        # Across the longer side: a map one column wide snakes down its rows.
        snake = _serpentine(height, width) if width >= 5 else _serpentine(width, height).T
        fg = np.stack([snake] * batch)
    else:
        fg = rng.rand(batch, height, width) < 0.6
    sentinel = height * width
    values = np.where(fg, np.arange(sentinel).reshape(height, width), sentinel)
    return torch.from_numpy(values.astype(np.int32)), torch.from_numpy(fg), sentinel


@pytest.mark.parametrize("kind", COVERAGE_MAPS)
@pytest.mark.parametrize("shape", COVERAGE_SHAPES, ids=str)
def test_kernel_writes_every_output_cell(device, shape, kind):
    """Both entries called through the library, ``dst`` poisoned first:
    after ``num_sweeps`` 0, 1 and 8 (with and without the convergence
    sweep) and after the keyed row/column pass no cell holds the poison,
    and the maps equal the plain versions'."""
    lib = cc_cuda._library()
    values, fg, sentinel = _coverage_maps(kind, *shape)
    dev_values = values.to(device)
    barrier = (~fg).to(torch.uint8).to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for sweeps in (0, 1, 8):
        for check in (False, True):
            out = torch.full_like(dev_values, POISON)
            flags = torch.zeros((sweeps + 1) * shape[0], dtype=torch.int32, device=device)
            rc = lib.cc_sweeps(dev_values.data_ptr(), out.data_ptr(), barrier.data_ptr(),
                               *shape, sentinel, sweeps, int(check), flags.data_ptr(), stream)
            torch.cuda.synchronize()
            assert rc == 0
            out = out.cpu()
            assert not bool((out == POISON).any()), (sweeps, check)
            ref = cc_cuda.segmented_min_sweeps_plain(values, ~fg, sentinel, sweeps + check)
            assert torch.equal(out, ref), (sweeps, check)
    key = torch.from_numpy(np.random.RandomState(shape[0]).randint(0, 3, size=shape)
                           .astype(np.int32))
    key = torch.where(fg, key, -1)
    # Held in names until the kernel has run: the allocator may hand a
    # temporary's memory to the next tensor before the launch executes.
    dev_fg, dev_key = fg.to(torch.uint8).to(device), key.to(device)
    out = torch.full_like(dev_values, POISON)
    rc = lib.cc_keyed_rows_cols(dev_values.data_ptr(), out.data_ptr(), dev_fg.data_ptr(),
                                dev_key.data_ptr(), *shape, sentinel, stream)
    torch.cuda.synchronize()
    assert rc == 0
    out = out.cpu()
    assert not bool((out == POISON).any())
    assert torch.equal(out, cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel))


@pytest.mark.parametrize("backbone", ["vgg", "efficientnetb0"])
def test_craft_batch_2_forward_keeps_batch_1_numbers(device, backbone):
    """cuDNN's float32 heuristics picked an FFT convolution for
    ``upconv2.block1.conv`` at batches 2-7 (14x batch 1's time per image at
    2x960x1280). The full-width CRAFT at batch 2 gives each image's batch-1
    heatmaps within 1e-4 * max(1, max|ref|). Its time per image against
    batch 1's is gated by ``chip_smoke.py`` phase 13 at every batch 1-8."""
    model = init_parameters(CRAFT(backbone), seed=0).to(device).eval()
    x = torch.randn((2, 960, 1280, 3), generator=torch.Generator().manual_seed(2)).to(device)
    with torch.inference_mode():
        ref = torch.cat([model(x[i : i + 1]) for i in range(2)])
        out = model(x)
    assert float((out - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


def _golden_variables(name):
    from keras_ocr_tpu_torch import weights

    return weights.read_npz(os.path.join(GOLDEN, name))


def _bf16_craft(name, fold_bn, variables):
    from keras_ocr_tpu_torch import weights

    if variables is None:
        return init_parameters(CRAFT(name, dtype=torch.bfloat16), seed=0).eval()
    model = CRAFT(name, fold_bn=fold_bn, width=0.25, dtype=torch.bfloat16).eval()
    state = weights.craft_state_dict(variables)
    model.load_state_dict(fold_bn_state_dict(state) if fold_bn else state)
    return model


@pytest.mark.parametrize("graph", ["vgg", "vgg folded", "efficientnetb0"])
def test_bf16_craft_on_card_matches_cpu(device, full_fp32, graph):
    """The bfloat16 CRAFT on the card (cuDNN bf16; the folded graph through
    the conv kernel's bf16 mode) against the same module on the CPU, to the
    CPU parity test's bars (``tests/test_torch_bf16.py``): standard max
    8e-3 * max(1, max|ref|) and mean 1e-3, folded 1.6e-2 and 2.5e-3."""
    name, fold_bn = graph.split()[0], graph.endswith("folded")
    variables = None if name != "vgg" else _golden_variables("detector_slim.npz")
    model = _bf16_craft(name, fold_bn, variables)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        model.to(device)
        chains = conv_cuda.conv_chain.launches
        out = model(x.to(device)).cpu()
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    assert conv_cuda.conv_chain.launches == chains + (12 if fold_bn else 0)
    worst, mean = float((out - ref).abs().max()), float((out - ref).abs().mean())
    scale = max(1.0, float(ref.abs().max()))
    assert worst <= (1.6e-2 if fold_bn else 8e-3) * scale, worst
    assert mean <= (2.5e-3 if fold_bn else 1e-3), mean


@pytest.mark.parametrize("shape", ["golden_slim", "production"])
def test_bf16_crnn_on_card_matches_cpu(device, full_fp32, shape):
    """The bfloat16 CRNN on the card (cuDNN's bf16 LSTM, float32 STN
    sampling and softmax) against the CPU's: softmax within 2e-2 (mean
    1e-3), argmax equal but where the CPU's top two are within 1e-2."""
    from keras_ocr_tpu_torch import Recognizer

    if shape == "golden_slim":
        meta = golden._read_json(GOLDEN, golden.META_NAME)
        recognizer = Recognizer(meta["alphabet"], None, dict(meta["recognizer_build_params"]),
                                torch.bfloat16, device="cpu")
        recognizer.load_variables(_golden_variables("recognizer_slim.npz"))
    else:
        recognizer = Recognizer(None, None, None, torch.bfloat16, device="cpu", seed=1)
        with torch.no_grad():
            dense2 = recognizer.model.stn.dense2
            gen = torch.Generator().manual_seed(0)
            dense2.weight.copy_(0.02 * torch.randn(dense2.weight.shape, generator=gen))
            dense2.bias.copy_(torch.tensor([0.9, 0.08, 0.05, -0.06, 1.1, 0.03]))
    model = recognizer.model
    x = torch.from_numpy(np.random.RandomState(4).rand(8, *recognizer.input_shape)
                         .astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        out = model.to(device)(x.to(device)).cpu()
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 2e-2
    assert float((out - ref).abs().mean()) <= 1e-3
    top2 = ref.topk(2, -1).values
    near_tie = top2[..., 0] - top2[..., 1] < 1e-2
    assert not ((out.argmax(-1) != ref.argmax(-1)) & ~near_tie).any()


@pytest.mark.parametrize("fold_bn", [False, True], ids=["standard", "folded"])
def test_bf16_golden_on_card_live_and_exported(device, tmp_path, fold_bn):
    """The golden artifact in bfloat16 on the card reads its pass fraction,
    and its export (batch 1) serves the live pipeline's words and packed
    output."""
    pipeline, meta = golden.load_golden_pipeline(GOLDEN, torch.bfloat16, device=device,
                                                 fold_bn=fold_bn)
    result = golden.run_golden_check(GOLDEN, pipeline=pipeline)
    assert result["pass"], result
    height, width = meta["pad_to"]
    path = str(tmp_path / "bf16")
    pipeline.export(path, height=height, width=width, batch_size=1)
    served = load_exported(path)
    image = tools.read(os.path.join(GOLDEN, result["per_scene"][0]["image"]))
    assert ([w for w, _ in served.recognize([image])[0]]
            == [w for w, _ in pipeline.recognize([image])[0]])


def _bf16_l2(ours, ref):
    return float(np.linalg.norm(ours.astype(np.float64) - ref)) / max(
        float(np.linalg.norm(ref.astype(np.float64))), 1e-12)


@pytest.mark.parametrize("model", ["crnn", "craft"])
def test_bf16_train_step_on_card_matches_cpu(device, full_fp32, model):
    """One bf16 step (float32 parameters) from one state on the card and on
    the CPU, at phase 11's sizes (the full-width CRNN at batch 8, dropout 0;
    CRAFT at width 1.0, 2x256x256), to the CPU parity test's bars
    (``tests/test_torch_train_bf16.py``): each gradient leaf within 0.5 in
    relative L2, leaves zero in exact arithmetic (read off the CPU's
    float32 step) below 3.3e-2 of the largest |g|, the running statistics
    within 6.8e-3, the loss within 1e-3; gradients float32; three ``fit``
    steps on the batch lower the loss."""
    from keras_ocr_tpu_torch import Detector, Recognizer, weights
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS

    rng = np.random.RandomState(16)
    if model == "crnn":
        bridge = weights.crnn_variables
        frames = 48
        label_length = rng.randint(1, 21, size=(8, 1))
        labels = np.full((8, frames), -1)
        for i, n in enumerate(label_length[:, 0]):
            labels[i, :n] = rng.randint(0, 36, size=n)
        batch = ((rng.rand(8, 31, 200, 1).astype(np.float32), labels,
                  np.full((8, 1), frames), label_length), np.zeros((8, 1)))
        params = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)

        def make(on, dtype):
            return Recognizer(None, None, params, dtype, device=on, seed=3)
    else:
        bridge = weights.craft_variables
        images = rng.randn(2, 256, 256, 3).astype(np.float32)
        targets = (rng.rand(2, 128, 128, 2) * 0.05).astype(np.float32)
        targets[:, 20:40, 10:70, 0] = 0.9
        batch = (images, targets)

        def make(on, dtype):
            return Detector(weights=None, width=1.0, compute_dtype=dtype, device=on, seed=4)

    card = make("cuda", torch.bfloat16)
    state = bridge(card.model)
    cpu = make("cpu", torch.bfloat16).load_variables(state)
    wide = make("cpu", torch.float32).load_variables(state)
    steps = {}
    for label, facade in (("card", card), ("cpu", cpu), ("float32", wide)):
        trainer = facade.compile(optimizer=lambda params: torch.optim.SGD(params, lr=0.0))
        loss = trainer.train_step(batch)
        steps[label] = (loss, _gradient_leaves(facade.model, bridge),
                        dict(weights_leaves(bridge(facade.model)["batch_stats"])))
    assert {p.grad.dtype for p in card.model.parameters() if p.grad is not None} == {
        torch.float32}
    (loss, grads, stats), (ref_loss, ref_grads, ref_stats) = steps["card"], steps["cpu"]
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
    float32_grads = steps["float32"][1]
    largest32 = max(np.abs(v).max() for v in float32_grads.values())
    zero = {k for k, v in float32_grads.items() if np.abs(v).max() <= 1e-4 * largest32}
    largest = max(np.abs(v).max() for v in ref_grads.values())
    for path, value in ref_grads.items():
        if path in zero:
            assert np.abs(grads[path]).max() <= 3.3e-2 * largest, path
        else:
            assert _bf16_l2(grads[path], value) <= 0.5, path
    for path, value in ref_stats.items():
        assert _bf16_l2(stats[path], value) <= 6.8e-3, path
    fresh = make("cuda", torch.bfloat16).load_variables(state)
    history = fresh.compile(learning_rate=3e-4).fit(iter([batch] * 3), steps_per_epoch=1,
                                                    epochs=3)
    assert np.isfinite(history).all() and history[-1] < history[0]


def weights_leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from weights_leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def test_bf16_trained_detector_folds_into_the_bf16_kernel(device, full_fp32):
    """A bf16 VGG CRAFT (width 0.25) after one train step on the card,
    folded (``fold_bn_state_dict``) into the bf16 folded graph: its forward
    launches the conv kernel's bf16 mode for all 12 chains, each within
    the bf16 mode's bars of the plain chain on the same tensors, and the
    heatmaps sit within the folded graph's CPU bars (1.6e-2 * max(1,
    max|ref|), mean 2.5e-3) of the CPU's folded forward."""
    from keras_ocr_tpu_torch import Detector
    from keras_ocr_tpu_torch.models import craft as craft_module

    rng = np.random.RandomState(17)
    detector = Detector(weights=None, width=0.25, compute_dtype=torch.bfloat16, device=device,
                        seed=7)
    detector.compile().train_step((rng.randn(2, 64, 96, 3).astype(np.float32),
                                   rng.rand(2, 32, 48, 2).astype(np.float32)))
    state = fold_bn_state_dict(detector.model.state_dict())
    folded = CRAFT(fold_bn=True, width=0.25, dtype=torch.bfloat16).eval()
    folded.load_state_dict({k: v.cpu() for k, v in state.items()})
    x = torch.from_numpy(rng.randn(2, 64, 96, 3).astype(np.float32))
    with torch.inference_mode():
        ref = folded(x)
        folded.to(device)
        chains = conv_cuda.conv_chain.launches
        calls = []

        class Checked:
            """``conv_cuda`` as the CRAFT module sees it, each chain also run
            through its plain bf16 version (the kernel's wrapper counts)."""

            def __getattr__(self, name):
                return getattr(conv_cuda, name)

            def conv_chain(self, x, convs, pool=False, tap_prepool=False):
                out = conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=tap_prepool)
                plain = conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap_prepool)
                for got, want in (zip(out, plain) if tap_prepool else ((out, plain),)):
                    assert got.dtype == torch.bfloat16
                    ulps = conv_cuda.bf16_ulps(got, want)
                    assert float((ulps <= 1.0).float().mean()) >= 0.99
                calls.append(len(convs))
                return out

        craft_module.conv_cuda = Checked()
        try:
            out = folded(x.to(device)).cpu()
        finally:
            craft_module.conv_cuda = conv_cuda
    assert len(calls) == 12 and conv_cuda.conv_chain.launches == chains + 12
    worst, mean = float((out - ref).abs().max()), float((out - ref).abs().mean())
    assert worst <= 1.6e-2 * max(1.0, float(ref.abs().max())), worst
    assert mean <= 2.5e-3, mean
