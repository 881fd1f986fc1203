"""Port parity: the conv wrappers of ``ops/conv_cuda.py`` on the CPU against
the JAX package's Pallas conv kernels in interpret mode.

On CPU tensors both wrappers run their plain versions (``F.conv2d``); the
same seeded inputs go through ``keras_ocr_tpu/ops/conv_pallas.py``
(``conv_chain``, ``conv3x3_bias_act``, ``interpret=True``, one image at a
time as the JAX package vmaps them) with the shapes of
``tests/test_conv_pallas.py``, held to its bar, ``atol=1e-4``. The TPU
kernel asserts even sizes under the pool; odd ones are held against
``lax.conv`` + ``lax.reduce_window`` VALID.

The kernel's operands are made by the wrapper in plain PyTorch, so they
are tested here too: the K-major weight order, the zero channel padding,
the TF32 split, and an emulation of the kernel's 3xTF32 product on them,
held to the bar ``chip_smoke.py`` holds the kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from keras_ocr_tpu.ops import conv_pallas
from keras_ocr_tpu_torch.ops import conv_cuda

torch.set_num_threads(2)

BATCH = 2


def _chain(rng, batch, height, width, cin, plan):
    """Seeded NHWC batch and HWIO convs as numpy arrays."""
    x = rng.rand(batch, height, width, cin).astype(np.float32)
    convs = []
    for k, cout, relu in plan:
        w = (rng.rand(k, k, cin, cout) - 0.5).astype(np.float32)
        b = ((rng.rand(cout) - 0.5) * 0.1).astype(np.float32)
        convs.append((w, b, relu))
        cin = cout
    return x, convs


def _torch_convs(convs):
    return [(torch.from_numpy(w), torch.from_numpy(b), relu) for w, b, relu in convs]


def _jax_convs(convs):
    return [(jnp.asarray(w), jnp.asarray(b), relu) for w, b, relu in convs]


def _pallas_chain(x, convs, pool, tap_prepool, tile_h):
    outs = [
        conv_pallas.conv_chain(
            jnp.asarray(image), _jax_convs(convs), pool=pool, tap_prepool=tap_prepool,
            tile_h=tile_h, interpret=True,
        )
        for image in x
    ]
    if tap_prepool:
        return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(2))
    return np.stack([np.asarray(o) for o in outs])


def _both_wrappers(x, convs, **kwargs):
    """The plain version and the wrapper on the same CPU tensors."""
    xt, ct = torch.from_numpy(x), _torch_convs(convs)
    return conv_cuda.conv_chain_plain(xt, ct, **kwargs), conv_cuda.conv_chain(xt, ct, **kwargs)


@pytest.mark.parametrize(
    "height,width,cin,plan,pool,tile_h",
    [
        (16, 24, 3, [(3, 16, True), (3, 16, True)], True, 8),
        (14, 16, 8, [(3, 8, True), (3, 16, True), (3, 8, False)], False, 8),
        (12, 16, 8, [(1, 16, True), (3, 8, True)], False, 4),
        (18, 20, 4, [(3, 8, True)], True, 8),
    ],
)
def test_conv_chain_matches_pallas(height, width, cin, plan, pool, tile_h):
    x, convs = _chain(np.random.RandomState(0), BATCH, height, width, cin, plan)
    ref = _pallas_chain(x, convs, pool, False, tile_h)
    for out in _both_wrappers(x, convs, pool=pool):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_conv_chain_tap_prepool_matches_pallas():
    x, convs = _chain(np.random.RandomState(3), BATCH, 16, 16, 4, [(3, 8, True), (3, 8, True)])
    ref_pooled, ref_tap = _pallas_chain(x, convs, True, True, 8)
    for pooled, tap in _both_wrappers(x, convs, pool=True, tap_prepool=True):
        np.testing.assert_allclose(tap.numpy(), ref_tap, rtol=0, atol=1e-4)
        np.testing.assert_allclose(pooled.numpy(), ref_pooled, rtol=0, atol=1e-4)


def _conv3x3_both(x, w, b, relu):
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    return (
        conv_cuda.conv3x3_bias_act_plain(*args, relu=relu),
        conv_cuda.conv3x3_bias_act(*args, relu=relu),
    )


@pytest.mark.parametrize(
    "height,width,cin,cout,relu",
    [(24, 40, 8, 16, True), (17, 33, 16, 8, False), (16, 128, 32, 32, True), (13, 24, 8, 8, True)],
)
def test_conv3x3_matches_pallas(height, width, cin, cout, relu):
    """The shapes of ``test_conv3x3_matches_lax_conv`` and the 13-row case
    of ``test_conv3x3_non_multiple_strip_height``."""
    rng = np.random.RandomState(0)
    x = rng.rand(height, width, cin).astype(np.float32)
    w = (rng.rand(3, 3, cin, cout) - 0.5).astype(np.float32)
    b = (rng.rand(cout) - 0.5).astype(np.float32)
    ref = np.asarray(conv_pallas.conv3x3_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_h=8, relu=relu, interpret=True
    ))
    for out in _conv3x3_both(x, w, b, relu):
        assert out.shape == ref.shape == (height, width, cout)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def _lax_chain(x, convs, pool):
    y = jnp.asarray(x)
    for w, b, relu in convs:
        y = jax.lax.conv_general_dilated(
            y, jnp.asarray(w), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        ) + b
        if relu:
            y = jnp.maximum(y, 0.0)
    tap = np.asarray(y)
    if pool:
        y = jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    return np.asarray(y), tap


@pytest.mark.parametrize("height,width", [(9, 13), (13, 37), (5, 8)])
def test_odd_pooled_chain_floors_like_reduce_window(height, width):
    """Odd sizes under the pool (CRAFT reaches 9x13 at slice4_30 from a
    72x104 input): the pool floors, the tap keeps the full size."""
    x, convs = _chain(
        np.random.RandomState(height), BATCH, height, width, 3, [(3, 16, True), (1, 2, False)]
    )
    ref, ref_tap = _lax_chain(x, convs, pool=True)
    for pooled, tap in _both_wrappers(x, convs, pool=True, tap_prepool=True):
        assert pooled.shape == ref.shape == (BATCH, height // 2, width // 2, 2)
        np.testing.assert_allclose(pooled.numpy(), ref, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tap.numpy(), ref_tap, rtol=0, atol=1e-4)


@pytest.mark.parametrize("k,cin,cout", [(3, 5, 7), (1, 16, 2), (3, 8, 131)])
def test_kmajor_weights_order_and_padding(k, cin, cout):
    w = torch.from_numpy(np.random.RandomState(cin).randn(k, k, cin, cout).astype(np.float32))
    cin_pad = -(-cin // 4) * 4
    kmajor = conv_cuda.kmajor_weights(w, cin_pad)
    assert kmajor.shape == (cout, k * k, cin_pad) and kmajor.is_contiguous()
    assert torch.equal(kmajor[..., :cin].reshape(cout, k * k * cin), w.reshape(k * k * cin, cout).T)
    assert not kmajor[..., cin:].any()
    split = conv_cuda.split_weights(w, cin_pad)
    assert split.shape == (2, cout, k * k, cin_pad)
    for part, want in zip(split, conv_cuda.tf32_split(kmajor)):
        assert torch.equal(part, want)


@pytest.mark.parametrize("cin", [3, 5])
def test_zero_channel_padding_leaves_conv_unchanged(cin):
    """The wrapper pads Cin to a multiple of 4 (TMA's 16-byte strides) in
    the input and the kernel alike; the conv must not change."""
    x, convs = _chain(np.random.RandomState(cin), BATCH, 9, 13, cin, [(3, 6, True)])
    (w, b, relu), = _torch_convs(convs)
    xt = torch.from_numpy(x)
    padded_w = conv_cuda.pad_channels(w.permute(0, 1, 3, 2), 8).permute(0, 1, 3, 2)
    padded = conv_cuda.conv3x3_bias_act_plain(conv_cuda.pad_channels(xt, 8), padded_w, b, relu)
    assert conv_cuda.pad_channels(xt, 8).shape[-1] == 8
    unpadded = conv_cuda.conv3x3_bias_act_plain(xt, w, b, relu)
    np.testing.assert_array_equal(padded.numpy(), unpadded.numpy())


def test_tf32_split():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096)).astype(np.float32))
    hi, lo = conv_cuda.tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 13 low mantissa bits
    exact = x.double()
    assert float(((hi.double() + lo.double() - exact).abs() / exact.abs()).max()) <= 2.0**-22
    # Round to nearest, ties away from zero, as cvt.rna.tf32.f32.
    ties = torch.tensor([0x3F801000, 0x3F803000, -0x407FF000, 0x3F800FFF], dtype=torch.int32)
    want = torch.tensor([0x3F802000, 0x3F804000, -0x407FE000, 0x3F800000], dtype=torch.int32)
    assert torch.equal(conv_cuda.tf32_round(ties.view(torch.float32)).view(torch.int32), want)


def _emulated_3xtf32(x, w, b, relu, passes=3):
    """The kernel's product on the wrapper's operands: im2col in the
    kernel's K order (tap, then channel), padded Cin, split weights, the
    activations split the same way, and hi*hi + hi*lo + lo*hi in fp32
    (``passes=1``: hi*hi alone, one TF32 product)."""
    k, cin = w.shape[0], x.shape[-1]
    cin_pad = -(-cin // 4) * 4
    xp = F.pad(conv_cuda.pad_channels(x, cin_pad), (0, 0, k // 2, k // 2, k // 2, k // 2))
    height, width = x.shape[1:3]
    taps = [xp[:, dy:dy + height, dx:dx + width] for dy in range(k) for dx in range(k)]
    cols = torch.cat(taps, -1)
    w_hi, w_lo = conv_cuda.split_weights(w, cin_pad).flatten(2)
    a_hi, a_lo = conv_cuda.tf32_split(cols)
    out = a_hi @ w_hi.T
    if passes == 3:
        out = a_hi @ w_lo.T + a_lo @ w_hi.T + out
    out = out + b
    return out.clamp_min(0) if relu else out


@pytest.mark.parametrize(
    "k,cin,cout", [(3, 3, 64), (1, 1536, 64), (3, 512, 32)], ids=["K27", "K1536", "K4608"]
)
def test_3xtf32_emulation_within_the_conv_bar(k, cin, cout):
    """At CRAFT's depths (C1's first layer, upconv1's 1x1, C5-C7) the
    3xTF32 product stays within 1e-4 * max(1, max|plain|) of F.conv2d;
    one TF32 product does not, which is why the kernel takes three."""
    x, convs = _chain(np.random.RandomState(k * cin), BATCH, 8, 10, cin, [(k, cout, True)])
    (w, b, relu), = _torch_convs(convs)
    xt = torch.from_numpy(x)
    ref = conv_cuda.conv_chain_plain(xt, [(w, b, relu)])
    bar = 1e-4 * max(1.0, float(ref.abs().max()))
    assert float((_emulated_3xtf32(xt, w, b, relu) - ref).abs().max()) <= bar
    assert float((_emulated_3xtf32(xt, w, b, relu, passes=1) - ref).abs().max()) > bar


def test_cpu_calls_count_no_launches():
    x, convs = _chain(np.random.RandomState(1), BATCH, 8, 10, 3, [(3, 8, True), (1, 4, True)])
    before = conv_cuda.conv_chain.launches, conv_cuda.conv3x3_bias_act.launches
    _both_wrappers(x, convs, pool=True, tap_prepool=True)
    w, b, _ = _torch_convs(convs)[0]
    conv_cuda.conv3x3_bias_act(torch.from_numpy(x), w, b)
    assert (conv_cuda.conv_chain.launches, conv_cuda.conv3x3_bias_act.launches) == before
