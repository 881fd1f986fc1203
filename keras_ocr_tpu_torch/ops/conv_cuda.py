"""The conv kernels of the BN-folded CRAFT graph and their plain versions.

Counterpart of ``keras_ocr_tpu/ops/conv_pallas.py``, with the same NHWC
signatures (images ``(H, W, Cin)`` or batches ``(B, H, W, Cin)``, kernels
HWIO, convs as ``(w, b, relu)`` with BatchNorm already folded in). On the
card both wrappers launch the hand-written tensor-core implicit GEMM of
``csrc/conv_chain.cu``, one launch per layer, as the op
``torch.ops.keras_ocr_tpu_torch.conv_layer``; for tensors on the CPU the op
runs the plain layer of :func:`conv3x3_bias_act_plain` and
:func:`conv_chain_plain`, built from ``F.conv2d``, ``F.relu`` and
``F.max_pool2d``. Inference only: the kernels have no backward.

Two modes, chosen by the input's dtype, as the TPU kernels follow theirs:

- float32: 3xTF32 ``wgmma`` fed by TMA, fp32 in, out and sums;
- bfloat16: the TPU kernels' arithmetic on a bf16 input. The float32
  weights are rounded to bf16 (``w.astype(x.dtype)``), the sums and the
  float32 bias, ReLU and pool are float32, and each layer's output (the
  next layer's input, the tap) is rounded once to bf16 (``buf_dtype``).
  On the card: a persistent warp-specialised kernel of bf16 ``wgmma``,
  both operands from shared memory.

The operands the kernel takes are made here, in plain PyTorch:
:func:`pad_channels` (TMA needs 16-byte strides, so Cin a multiple of 4 in
float32 and of 8 in bf16), :func:`kmajor_weights` (``wgmma`` reads both
operands K-major) and, in float32, :func:`tf32_split` (the hi and lo parts
of the 3xTF32 product). :func:`prepared_weight` makes a weight's operand
once per tensor and version and keeps it while that tensor lives: a caller
that passes the same HWIO tensors again (the folded CRAFT keeps its own,
``models/craft.py``) pays for no copy, one that passes new ones gets them
prepared per call. :func:`tile_n` and :func:`slab_channels` choose the
kernel's Cout tile and K slab for a layer; the kernel takes what they say.

Launch counts, kept by the op's CUDA kernel (so that an exported program's
launches count too): ``conv3x3_bias_act.launches`` counts every launch of a
3x3 layer that is not a pooled last layer (from either wrapper);
``conv_chain.launches`` counts each call of :func:`conv_chain` that
launched, its 1x1 layers and pooled last layers included.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch
from torch.nn import functional as F

from .. import kernels

SOURCE = "conv_chain.cu"
_ENCODE_ERROR = 10000  # conv_layer returns this + the CUresult of a failed encode


def _to_nchw(x):
    # contiguous(): cuDNN runs a permuted NHWC tensor in its slow
    # channels-last fp32 kernels.
    return x.permute(0, 3, 1, 2).contiguous()


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _batched(x):
    """(B, H, W, C) view of an image or a batch, and whether to squeeze."""
    if x.dim() == 3:
        return x.unsqueeze(0), True
    if x.dim() == 4:
        return x, False
    raise ValueError(f"expected (H, W, C) or (B, H, W, C), got {tuple(x.shape)}")


def _plain_layer(x_nchw, w, b, relu):
    """One conv + bias (+ReLU) in the input's dtype. A bf16 input is the
    TPU kernel's bf16 arithmetic: float32 conv of the bf16 input and the
    bf16-rounded weights, float32 bias and ReLU, one rounding to bf16."""
    if x_nchw.dtype == torch.bfloat16:
        y = _plain_layer(x_nchw.float(), w.to(torch.bfloat16).float(), b.float(), relu)
        return y.to(torch.bfloat16)
    y = F.conv2d(x_nchw, w.permute(3, 2, 0, 1).contiguous(), b, padding=w.shape[0] // 2)
    return F.relu(y) if relu else y


def conv3x3_bias_act_plain(x, w, b, relu=True):
    """3x3 SAME conv + bias (+ReLU) of NHWC ``x`` with HWIO ``w``, in
    ``x``'s mode (float32, or bf16 as :func:`_plain_layer` says)."""
    x4, squeeze = _batched(x)
    y = _to_nhwc(_plain_layer(_to_nchw(x4), w, b, relu))
    return y[0] if squeeze else y


def conv_chain_plain(x, convs, pool=False, tap_prepool=False):
    """The chain of :func:`conv_chain` with ``F.conv2d``; the pool floors
    odd sizes like ``F.max_pool2d(2, 2)``. In the bf16 mode each layer
    rounds once; the TPU kernel pools the float32 values and rounds after,
    which gives the same result (rounding keeps the order)."""
    x4, squeeze = _batched(x)
    y = _to_nchw(x4)
    for w, b, relu in convs:
        y = _plain_layer(y, w, b, relu)
    tap = _to_nhwc(y)
    main = _to_nhwc(F.max_pool2d(y, 2, 2)) if pool else tap
    if squeeze:
        main, tap = main[0], tap[0]
    return (main, tap) if tap_prepool else main


def bf16_ulps(out, ref, floor=2.0 ** -8):
    """``|out - ref|`` per element in units of the bf16 spacing (one ulp)
    at ``max(|out|, |ref|)``; magnitudes below ``floor * max|ref|`` are
    measured at that level, since a float32 sum that cancels to near zero
    differs between summation orders by more than its own bf16 ulp. The
    measure of the bf16 mode's bars (one ulp for a layer)."""
    out, ref = out.float(), ref.float()
    level = max(floor * float(ref.abs().max()), torch.finfo(torch.float32).tiny)
    scale = torch.maximum(out.abs(), ref.abs()).clamp_min(level)
    return (out - ref).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def pad_channels(x, channels):
    """``x`` with its last dimension zero-padded to ``channels``."""
    extra = channels - x.shape[-1]
    return F.pad(x, (0, extra)) if extra else x


def cin_multiple(dtype):
    """The kernel's channel multiple for a mode: 16 bytes of channels."""
    return 8 if dtype == torch.bfloat16 else 4


def kmajor_weights(w, cin_pad):
    """HWIO ``(k, k, Cin, Cout)`` as the kernel's K-major ``(Cout, k*k,
    cin_pad)``, zero past Cin: row n is ``w.reshape(k*k*Cin, Cout)[:, n]``
    tap by tap."""
    k, _, cin, cout = w.shape
    return pad_channels(w.permute(3, 0, 1, 2).reshape(cout, k * k, cin), cin_pad).contiguous()


def tf32_round(x):
    """float32 rounded to TF32 (10 mantissa bits; nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds on the card."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(hi, lo), both TF32, with hi + lo = x to about 2**-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_weights(w, cin_pad):
    """The kernel's weight operand: ``(2, Cout, k*k, cin_pad)``, the hi and
    lo parts of :func:`kmajor_weights`."""
    return torch.stack(tf32_split(kmajor_weights(w, cin_pad)))


# A bf16 3x3 layer of at most this many input channels times 9 runs as a
# 1x1 layer on its im2col (:func:`im2col`).
IM2COL_CHANNELS = 32


def uses_im2col(k, cin, dtype):
    """Whether the kernel takes a layer as a 1x1 layer on its im2col: in
    bf16, a 3x3 layer whose 9 * Cin taps fit 32 channels (C1's first layer,
    Cin 3). TMA would otherwise fetch 9 boxes a tile whose rows are mostly
    zero fill past Cin (0.52 ms at 960x1280 on an H100), which costs more
    than writing and reading back the 79 MB of columns (about 0.2 ms: 0.056
    for the columns made by ``conv_im2col_bf16``, 0.147 for the 1x1 layer;
    ``scripts/conv_kernel_ab.py`` measures both)."""
    return dtype == torch.bfloat16 and k == 3 and 9 * cin <= IM2COL_CHANNELS


def im2col(x):
    """(B, H, W, 32) columns of a 3x3 SAME conv of NHWC ``x``: tap (dy, dx)
    of channel c at ``(dy * 3 + dx) * Cin + c``, as an HWIO kernel reshaped
    to (1, 1, 9 * Cin, Cout) reads them; zeros after."""
    batch, height, width, cin = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [padded[:, dy:dy + height, dx:dx + width] for dy in range(3) for dx in range(3)]
    taps.append(x.new_zeros((batch, height, width, IM2COL_CHANNELS - 9 * cin)))
    return torch.cat(taps, -1)


def weight_operand(w, cin_pad, dtype):
    """The kernel's weight operand for HWIO ``w`` in the mode of ``dtype``:
    :func:`kmajor_weights` rounded to bf16, or the float32 mode's
    :func:`split_weights`; contiguous and 16-byte aligned. A kernel that
    :func:`uses_im2col` takes the (1, 1, 9 * Cin, Cout) form."""
    if uses_im2col(w.shape[0], w.shape[2], dtype):
        w = w.reshape(1, 1, -1, w.shape[3])
    if dtype == torch.bfloat16:
        return _aligned(kmajor_weights(w, cin_pad).to(torch.bfloat16))
    return _aligned(split_weights(w, cin_pad))


# id(source tensor) -> (weak reference, version, {(cin_pad, dtype): operand})
_operands = {}


def _version(t):
    """``t._version``, or None for an inference tensor (no counter)."""
    return None if t.is_inference() else t._version


def prepared_weight(w, cin_pad, dtype):
    """:func:`weight_operand` of ``w``, made once per tensor and version.

    The operand is kept while ``w`` lives and its version counter stands
    (an in-place change to ``w`` makes it anew); inference tensors, which
    keep no counter, and traced tensors are prepared per call."""
    version = None if torch.compiler.is_compiling() else _version(w)
    if version is None:
        return weight_operand(w, cin_pad, dtype)
    key = id(w)
    entry = _operands.get(key)
    if entry is None or entry[0]() is not w or entry[1] != version:
        ref = weakref.ref(w, lambda _, key=key: _operands.pop(key, None))
        entry = _operands[key] = (ref, version, {})
    made = entry[2]
    operand = made.get((cin_pad, dtype))
    if operand is None:
        operand = made[cin_pad, dtype] = weight_operand(w.detach(), cin_pad, dtype)
    return operand


# The SMs tile_n plans for when it is not given a card's count: an H100's.
H100_SMS = 132
_TILES = (8, 16, 32, 64, 128)


def tile_n(cout, tiles_m=None, dtype=torch.float32, sms=H100_SMS):
    """The Cout tile (``wgmma`` N) of a layer: the narrowest of 8 ... 128
    that holds ``cout``, else 128 (several column tiles).

    In bf16, 256 where ``cout >= 256`` and the persistent grid's rounds
    (``ceil(tiles / sms)`` over the layer's ``tiles_m`` pixel patches of
    8 x 16) at 256 cost less than at 128, a 256-wide tile taking 1.5 times
    a 128-wide one (1.47-1.63 measured on the H100 at C3 and C5,
    ``scripts/conv_kernel_ab.py --tiles``): C3-C7 and upconv1's 1x1 at
    960x1280, not upconv1's 3x3 (one round either way) nor upconv2's 1x1
    (3 rounds against 2, a tie)."""
    narrow = next((n for n in _TILES if cout <= n), _TILES[-1])
    if dtype != torch.bfloat16 or cout < 256 or tiles_m is None:
        return narrow

    def rounds(n):
        return -(-tiles_m * -(-cout // n) // sms)

    return 256 if 3 * rounds(256) < 2 * rounds(128) else narrow


def slab_channels(cin_pad, dtype=torch.float32):
    """The input channels of one K step: 32 (128 bytes) in float32; in bf16
    16, 32 or 64 (32, 64 or 128 bytes), the narrowest that holds
    ``cin_pad``, so a narrow layer walks no zero slab."""
    if dtype != torch.bfloat16:
        return 32
    return 16 if cin_pad <= 16 else 32 if cin_pad <= 32 else 64


def tiles_m(batch, height, width):
    """The 8 x 16 pixel patches (M tiles) of a layer."""
    return batch * -(-height // 8) * -(-width // 16)


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernels.load(SOURCE)
    pointer, number = ctypes.c_void_p, ctypes.c_int
    lib.conv_layer.argtypes = [pointer] * 5 + [number] * 9 + [pointer]
    lib.conv_layer_bf16.argtypes = [pointer] * 5 + [number] * 11 + [pointer]
    lib.conv_im2col_bf16.argtypes = [pointer] * 2 + [number] * 4 + [pointer]
    for entry in (lib.conv_layer, lib.conv_layer_bf16, lib.conv_im2col_bf16):
        entry.restype = number
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(device):
    """The current stream of a CUDA device, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def _aligned(t):
    """Contiguous, with the 16-byte alignment TMA needs (a view into a
    larger tensor may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, convs):
    """Validate a (B, H, W, Cin) CUDA input and its HWIO convs; shapes,
    dtypes and devices only, so that it traces. The input is float32 or
    bfloat16 (the kernel's two modes); weights and biases are float32."""
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if not convs:
        raise ValueError("a chain needs at least one conv")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the conv kernel takes a float32 or bfloat16 input; got {x.dtype}")
    cin = x.shape[-1]
    for w, b, _ in convs:
        for name, t in (("weight", w), ("bias", b)):
            if t.dtype != torch.float32:
                raise TypeError(f"the conv kernel takes float32 {name}s; got {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"{name} on {t.device}, input on {x.device}")
        k = w.shape[0]
        if w.dim() != 4 or k not in (1, 3) or w.shape[1] != k or w.shape[2] != cin:
            raise ValueError(f"kernel {tuple(w.shape)} is not (k, k, {cin}, Cout), k in (1, 3)")
        if b.shape != (w.shape[3],):
            raise ValueError(f"bias {tuple(b.shape)} does not match kernel {tuple(w.shape)}")
        cin = w.shape[3]


kernels.LIBRARY.define(
    "conv_layer(Tensor x, Tensor weight, Tensor bias, bool relu, bool pool, bool tap, "
    "bool chain_start) -> (Tensor, Tensor)"
)


def _layer_cpu(x, weight, bias, relu, pool, tap, chain_start):
    """The plain layer: :func:`conv_chain_plain` of one conv."""
    y = _plain_layer(_to_nchw(x), weight, bias, relu)
    out = _to_nhwc(F.max_pool2d(y, 2, 2) if pool else y)
    return out, _to_nhwc(y) if tap else x.new_empty(0)


def _im2col_cuda(x):
    """:func:`im2col` of a CUDA bf16 ``x`` by the ``conv_im2col_bf16``
    kernel (bit for bit the plain version's columns)."""
    x = x.contiguous()
    batch, height, width, cin = x.shape
    out = torch.empty((batch, height, width, IM2COL_CHANNELS), dtype=x.dtype, device=x.device)
    rc = _library().conv_im2col_bf16(x.data_ptr(), out.data_ptr(), batch, height, width, cin,
                                     _stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"conv_im2col_bf16 launch failed with CUDA error {rc}")
    return out


def kernel_operands(x, weight):
    """(input, weight operand, k, Cin) that the kernel takes for a layer on
    (B, H, W, Cin) ``x`` with an HWIO ``weight``: Cin padded to the mode's
    multiple, or, where :func:`uses_im2col`, the layer as a 1x1 on its
    im2col (on the card by ``conv_im2col_bf16``)."""
    k, cin = weight.shape[0], x.shape[3]
    if uses_im2col(k, cin, x.dtype):
        cols = _im2col_cuda(x) if x.device.type == "cuda" else im2col(x)
        return cols, prepared_weight(weight, IM2COL_CHANNELS, x.dtype), 1, IM2COL_CHANNELS
    multiple = cin_multiple(x.dtype)
    cin_pad = -(-cin // multiple) * multiple
    return (_aligned(pad_channels(x, cin_pad)), prepared_weight(weight, cin_pad, x.dtype), k,
            cin_pad)


def _layer_cuda(x, weight, bias, relu, pool, tap, chain_start):
    """One launch of the kernel on (B, H, W, Cin) ``x`` with an HWIO
    ``weight`` (its operand from :func:`prepared_weight`): a 3x3 layer that
    is not pooled counts in ``conv3x3_bias_act.launches``, the first layer of
    a chain in ``conv_chain.launches``."""
    batch, height, width, _ = x.shape
    k, cout = weight.shape[0], weight.shape[3]
    out_hw = (height // 2, width // 2) if pool else (height, width)
    out = torch.empty((batch, *out_hw, cout), dtype=x.dtype, device=x.device)
    tap_out = (
        torch.empty((batch, height, width, cout), dtype=x.dtype, device=x.device)
        if tap else x.new_empty(0)
    )
    if (tap_out if tap else out).numel() == 0:
        return out, tap_out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        x, wmat, k_run, cin_pad = kernel_operands(x, weight)
        bias = _aligned(bias)
        sms = _sm_count(index)
        args = (x.data_ptr(), wmat.data_ptr(), bias.data_ptr(), out.data_ptr(),
                tap_out.data_ptr() if tap else None, batch, height, width, cin_pad, cout, k_run,
                int(bool(relu)), int(pool),
                tile_n(cout, tiles_m(batch, height, width), x.dtype, sms))
        if x.dtype == torch.bfloat16:
            rc = _library().conv_layer_bf16(*args, slab_channels(cin_pad, x.dtype), sms,
                                            _stream(index))
        else:
            rc = _library().conv_layer(*args, _stream(index))
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"conv_layer: cuTensorMapEncodeTiled failed with CUresult "
                           f"{rc - _ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"conv_layer launch failed with CUDA error {rc}")
    conv3x3_bias_act.launches += k == 3 and not pool
    conv_chain.launches += bool(chain_start)
    return out, tap_out


def _layer_fake(x, weight, bias, relu, pool, tap, chain_start):
    batch, height, width, _ = x.shape
    cout = weight.shape[3]
    out_hw = (height // 2, width // 2) if pool else (height, width)
    tap_out = x.new_empty((batch, height, width, cout)) if tap else x.new_empty(0)
    return x.new_empty((batch, *out_hw, cout)), tap_out


kernels.LIBRARY.impl("conv_layer", _layer_cpu, "CPU")
kernels.LIBRARY.impl("conv_layer", _layer_cuda, "CUDA")
torch.library.register_fake(f"{kernels.NAMESPACE}::conv_layer", _layer_fake, lib=kernels.LIBRARY)


def _layer(x, w, b, relu, pool=False, tap=False, chain_start=False):
    """One call of the op ``torch.ops.keras_ocr_tpu_torch.conv_layer`` on
    (B, H, W, Cin) ``x``; returns (out, tap, whose size is 0 without
    ``tap``)."""
    return torch.ops.keras_ocr_tpu_torch.conv_layer(
        x, w, b, bool(relu), bool(pool), bool(tap), bool(chain_start)
    )


def _validate(x4, convs):
    """CUDA inputs are checked before dispatch; the CPU takes the plain
    version as it is; other devices raise."""
    if x4.device.type != "cpu":
        _check(x4, convs)


def conv3x3_bias_act(x, w, b, tile_h=8, relu=True, interpret=False, out_dtype=None):
    """Fused 3x3 SAME stride-1 conv + bias (+ReLU) on NHWC float32 or
    bfloat16 images (the kernel's two modes; weights and bias float32).

    Port of ``keras_ocr_tpu/ops/conv_pallas.py:conv3x3_bias_act``, in its
    argument order. ``tile_h`` and ``interpret`` (the TPU kernel's row
    strip and its interpreter) are accepted and ignored.

    Args:
        x: (H, W, Cin) or (B, H, W, Cin).
        w: (3, 3, Cin, Cout) HWIO kernel (BatchNorm folded in).
        b: (Cout,) bias.
        out_dtype: the output's dtype (default ``x``'s); the layer writes
            ``x``'s, which is then cast, so a bfloat16 layer's float32
            output holds bf16 values.

    Returns:
        (H, W, Cout) or (B, H, W, Cout): one ``conv_layer`` op. CPU tensors
        take the plain layer (:func:`conv3x3_bias_act_plain`); CUDA tensors
        launch the kernel (counted in ``conv3x3_bias_act.launches``) or
        raise.
    """
    del tile_h, interpret
    x4, squeeze = _batched(x)
    _validate(x4, [(w, b, relu)])
    if w.shape[0] != 3:
        raise ValueError(f"conv3x3_bias_act takes a 3x3 kernel, got {tuple(w.shape)}")
    out, _ = _layer(x4, w, b, relu)
    out = out.to(out_dtype or out.dtype)
    return out[0] if squeeze else out


conv3x3_bias_act.launches = 0


def conv_chain(x, convs, pool=False, tap_prepool=False, tile_h=16, interpret=False,
               out_dtype=None):
    """Chain of 1x1 / 3x3 SAME convs + bias (+ReLU each), optionally ending
    in a 2x2 stride-2 max-pool.

    Port of ``keras_ocr_tpu/ops/conv_pallas.py:conv_chain``, in its
    argument order: ``tile_h`` and ``interpret`` are accepted and ignored,
    ``out_dtype`` is the dtype of the output (and of the tap; default
    ``x``'s), cast from the last layer's ``x``-dtype result. Odd sizes are
    floored by the pool, like ``F.max_pool2d(2, 2)``, where the TPU kernel
    requires even ones.

    Args:
        x: (H, W, Cin) or (B, H, W, Cin) NHWC, float32 or bfloat16; the
            layers compute in its dtype.
        convs: sequence of (w, b, relu), w of shape (k, k, Cin, Cout) HWIO
            with k in {1, 3}, b of shape (Cout,); BatchNorm folded in.
        pool: end with a 2x2 stride-2 VALID max-pool.
        tap_prepool: also return the last conv's pre-pool activation.

    Returns:
        The (pooled) output; with ``tap_prepool`` a tuple (output, prepool).
        One ``conv_layer`` op per layer, intermediates through memory. CPU
        tensors take the plain layers (the values of
        :func:`conv_chain_plain`). CUDA tensors launch one kernel per layer:
        3x3 layers as :func:`conv3x3_bias_act`, 1x1 layers in the kernel's
        1x1 mode, a pooled last layer in its pooled epilogue (with the tap);
        the first launch counts the chain in ``conv_chain.launches``; or
        raise.
    """
    del tile_h, interpret
    x4, squeeze = _batched(x)
    _validate(x4, convs)
    if not convs:
        raise ValueError("a chain needs at least one conv")
    y, tap = x4, None
    for i, (w, b, relu) in enumerate(convs):
        last_pooled = pool and i == len(convs) - 1
        y, layer_tap = _layer(y, w, b, relu, pool=last_pooled,
                              tap=last_pooled and tap_prepool, chain_start=i == 0)
        if last_pooled:
            tap = layer_tap
    if tap_prepool and not pool:
        tap = y
    out_dtype = out_dtype or y.dtype
    y, tap = y.to(out_dtype), tap.to(out_dtype) if tap is not None else None
    if squeeze:
        y, tap = y[0], tap[0] if tap is not None else None
    return (y, tap) if tap_prepool else y


conv_chain.launches = 0
