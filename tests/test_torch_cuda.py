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
and falling losses.

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
        RecognizerTrainer, lambda on: Recognizer(build_params=params, device=on, seed=3),
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
        DetectorTrainer, lambda on: Detector(width=1.0, device=on, seed=4),
        weights.craft_variables, (images, targets), loss=loss)
    losses = [first] + [trainer.train_step((images, targets)) for _ in range(19)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
