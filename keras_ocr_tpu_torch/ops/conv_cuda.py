"""The conv kernels of the BN-folded CRAFT graph and their plain versions.

Counterpart of ``keras_ocr_tpu/ops/conv_pallas.py``, with the same NHWC
signatures (images ``(H, W, Cin)`` or batches ``(B, H, W, Cin)``, kernels
HWIO, convs as ``(w, b, relu)`` with BatchNorm already folded in). On the
card both wrappers launch the hand-written tensor-core implicit GEMM of
``csrc/conv_chain.cu`` (3xTF32 ``wgmma`` fed by TMA: fp32 in, out and
sums), one launch per layer, as the op
``torch.ops.keras_ocr_tpu_torch.conv_layer``; for tensors on the CPU the op
runs the plain layer of :func:`conv3x3_bias_act_plain` and
:func:`conv_chain_plain`, built from ``F.conv2d``, ``F.relu`` and
``F.max_pool2d``. Inference only: the kernels have no backward.

The operands the kernel takes are made here, in plain PyTorch:
:func:`pad_channels` (TMA needs 16-byte strides, so Cin a multiple of 4),
:func:`kmajor_weights` (the tf32 ``wgmma`` reads both operands K-major) and
:func:`tf32_split` (the hi and lo parts of the 3xTF32 product).

Launch counts, kept by the op's CUDA kernel (so that an exported program's
launches count too): ``conv3x3_bias_act.launches`` counts every launch of a
3x3 layer that is not a pooled last layer (from either wrapper);
``conv_chain.launches`` counts each call of :func:`conv_chain` that
launched, its 1x1 layers and pooled last layers included.
"""

from __future__ import annotations

import ctypes

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
    y = F.conv2d(x_nchw, w.permute(3, 2, 0, 1).contiguous(), b, padding=w.shape[0] // 2)
    return F.relu(y) if relu else y


def conv3x3_bias_act_plain(x, w, b, relu=True):
    """3x3 SAME conv + bias (+ReLU) of NHWC ``x`` with HWIO ``w``."""
    x4, squeeze = _batched(x)
    y = _to_nhwc(_plain_layer(_to_nchw(x4), w, b, relu))
    return y[0] if squeeze else y


def conv_chain_plain(x, convs, pool=False, tap_prepool=False):
    """The chain of :func:`conv_chain` with ``F.conv2d``; the pool floors
    odd sizes like ``F.max_pool2d(2, 2)``."""
    x4, squeeze = _batched(x)
    y = _to_nchw(x4)
    for w, b, relu in convs:
        y = _plain_layer(y, w, b, relu)
    tap = _to_nhwc(y)
    main = _to_nhwc(F.max_pool2d(y, 2, 2)) if pool else tap
    if squeeze:
        main, tap = main[0], tap[0]
    return (main, tap) if tap_prepool else main


def pad_channels(x, channels):
    """``x`` with its last dimension zero-padded to ``channels``."""
    extra = channels - x.shape[-1]
    return F.pad(x, (0, extra)) if extra else x


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


def _library():
    lib = kernels.load(SOURCE)
    pointer, number = ctypes.c_void_p, ctypes.c_int
    lib.conv_layer.argtypes = [pointer] * 5 + [number] * 8 + [pointer]
    lib.conv_layer.restype = number
    lib.conv_tile_n.argtypes = [number]
    lib.conv_tile_n.restype = number
    return lib


def tile_n(cout):
    """The Cout tile (``wgmma`` N) the kernel takes for ``cout`` channels."""
    return _library().conv_tile_n(cout)


def _aligned(t):
    """Contiguous, with the 16-byte alignment TMA needs (a view into a
    larger tensor may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, convs):
    """Validate a (B, H, W, Cin) CUDA input and its HWIO convs; shapes,
    dtypes and devices only, so that it traces."""
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if not convs:
        raise ValueError("a chain needs at least one conv")
    cin = x.shape[-1]
    for w, b, _ in convs:
        for name, t in (("input", x), ("weight", w), ("bias", b)):
            if t.dtype != torch.float32:
                raise TypeError(f"the conv kernel takes float32; {name} is {t.dtype}")
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


def _layer_cuda(x, weight, bias, relu, pool, tap, chain_start):
    """One launch of the kernel on (B, H, W, Cin) ``x`` with an HWIO
    ``weight``: a 3x3 layer that is not pooled counts in
    ``conv3x3_bias_act.launches``, the first layer of a chain in
    ``conv_chain.launches``."""
    batch, height, width, cin = x.shape
    k, cout = weight.shape[0], weight.shape[3]
    cin_pad = -(-cin // 4) * 4
    x = _aligned(pad_channels(x, cin_pad))
    wsplit = _aligned(split_weights(weight, cin_pad))
    bias = _aligned(bias)
    out_hw = (height // 2, width // 2) if pool else (height, width)
    out = torch.empty((batch, *out_hw, cout), dtype=torch.float32, device=x.device)
    tap_out = (
        torch.empty((batch, height, width, cout), dtype=torch.float32, device=x.device)
        if tap else x.new_empty(0)
    )
    if (tap_out if tap else out).numel() == 0:
        return out, tap_out
    with torch.cuda.device(x.device):
        rc = _library().conv_layer(
            x.data_ptr(), wsplit.data_ptr(), bias.data_ptr(), out.data_ptr(),
            tap_out.data_ptr() if tap else None, batch, height, width, cin_pad, cout,
            k, int(bool(relu)), int(pool), torch.cuda.current_stream(x.device).cuda_stream,
        )
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


def conv3x3_bias_act(x, w, b, relu=True):
    """Fused 3x3 SAME stride-1 conv + bias (+ReLU) on NHWC float32 images.

    Port of ``keras_ocr_tpu/ops/conv_pallas.py:conv3x3_bias_act`` (no
    ``tile_h``, no ``interpret``).

    Args:
        x: (H, W, Cin) or (B, H, W, Cin).
        w: (3, 3, Cin, Cout) HWIO kernel (BatchNorm folded in).
        b: (Cout,) bias.

    Returns:
        (H, W, Cout) or (B, H, W, Cout): one ``conv_layer`` op. CPU tensors
        take the plain layer (:func:`conv3x3_bias_act_plain`); CUDA tensors
        launch the kernel (counted in ``conv3x3_bias_act.launches``) or
        raise.
    """
    x4, squeeze = _batched(x)
    _validate(x4, [(w, b, relu)])
    if w.shape[0] != 3:
        raise ValueError(f"conv3x3_bias_act takes a 3x3 kernel, got {tuple(w.shape)}")
    out, _ = _layer(x4, w, b, relu)
    return out[0] if squeeze else out


conv3x3_bias_act.launches = 0


def conv_chain(x, convs, pool=False, tap_prepool=False):
    """Chain of 1x1 / 3x3 SAME convs + bias (+ReLU each), optionally ending
    in a 2x2 stride-2 max-pool.

    Port of ``keras_ocr_tpu/ops/conv_pallas.py:conv_chain`` (no ``tile_h``,
    no ``interpret``). Odd sizes are floored by the pool, like
    ``F.max_pool2d(2, 2)``, where the TPU kernel requires even ones.

    Args:
        x: (H, W, Cin) or (B, H, W, Cin) float32 NHWC.
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
    if squeeze:
        y, tap = y[0], tap[0] if tap is not None else None
    return (y, tap) if tap_prepool else y


conv_chain.launches = 0
