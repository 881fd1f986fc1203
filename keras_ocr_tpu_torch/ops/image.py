"""Device image ops on NHWC tensors: normalisation and its inverse, resize,
grayscale.

Port of ``keras_ocr_tpu/ops/image.py``. Everything here is elementwise or
two-tap gathers in float32; nothing goes through a matrix product, so no
TF32 path can change the numbers on the card. A bfloat16 resize rounds
where the JAX function does on a bfloat16 input.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_VARIANCE = (0.229, 0.224, 0.225)


def _constant(values, device):
    """A float32 vector made on ``device`` by fill kernels: a host-to-device
    copy of pageable memory would make the host wait for the device."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in values])


def compute_input(image):
    """ImageNet mean/variance normalisation of RGB images in [0, 255]."""
    image = image.to(torch.float32)
    mean = _constant(IMAGENET_MEAN, image.device) * 255.0
    variance = _constant(IMAGENET_VARIANCE, image.device) * 255.0
    return (image - mean) / variance


def invert_input(x):
    """Inverse of :func:`compute_input`: uint8 RGB, clipped to [0, 255]."""
    mean = _constant(IMAGENET_MEAN, x.device) * 255.0
    variance = _constant(IMAGENET_VARIANCE, x.device) * 255.0
    return torch.clamp(x.to(torch.float32) * variance + mean, 0, 255).to(torch.uint8)


def _upscale2x(x, dims=(1, 2)):
    """Exact 2x half-pixel-centers bilinear upsample of an NHWC batch
    (``dims`` names the two spatial dimensions of another layout).

    out[2i] = 0.25*in[i-1] + 0.75*in[i]; out[2i+1] = 0.75*in[i] +
    0.25*in[i+1], edge-clamped, per axis; a bfloat16 input rounds after
    each product and the sum, as the JAX function does on one.
    """

    def axis_up(v, dim):
        size = v.shape[dim]
        lo = torch.cat([v.narrow(dim, 0, 1), v.narrow(dim, 0, size - 1)], dim)
        hi = torch.cat([v.narrow(dim, 1, size - 1), v.narrow(dim, size - 1, 1)], dim)
        even = 0.25 * lo + 0.75 * v
        odd = 0.75 * v + 0.25 * hi
        stacked = torch.stack([even, odd], dim=dim + 1)
        shape = list(v.shape)
        shape[dim] = size * 2
        return stacked.reshape(shape)

    return axis_up(axis_up(x, dims[0]), dims[1])


def _axis_taps(in_size, out_size, device):
    """Half-pixel-centers source taps (lo, hi, frac) along one axis."""
    scale = in_size / out_size
    centers = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    centers = centers.clamp(0.0, in_size - 1)
    lo = torch.floor(centers).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    frac = centers - lo.to(torch.float32)
    return lo, hi, frac


def _resize_axis(x, dim, lo, hi, frac):
    """``x`` interpolated along ``dim`` at the taps (lo, hi, frac) of
    :func:`_axis_taps`, in :func:`resize_bilinear`'s arithmetic."""
    dtype = x.dtype
    wide_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    shape = [1] * x.dim()
    shape[dim] = lo.numel()
    frac = frac.to(wide_dtype)
    w_lo, w_hi = 1.0 - frac, frac
    if dtype != wide_dtype:
        # The JAX function's interpolation matrix holds the weights in the
        # input's dtype.
        w_lo, w_hi = w_lo.to(dtype).to(wide_dtype), w_hi.to(dtype).to(wide_dtype)
    wide = x.to(wide_dtype)
    return (w_lo.reshape(shape) * wide.index_select(dim, lo)
            + w_hi.reshape(shape) * wide.index_select(dim, hi)).to(dtype)


def resize_bilinear(x, height, width, dims=(1, 2)):
    """Bilinear resize with half-pixel centers of an NHWC batch (``dims``
    names the two spatial dimensions of another layout).

    Same sampling as ``keras_ocr_tpu/ops/image.py:resize_bilinear`` (centers
    clipped to the source), written as two-tap gathers per axis instead of
    interpolation matrices. A bfloat16 input is interpolated in float32
    with bf16 weights and rounded once per axis, as the JAX function's
    bf16 matrices and products; an exact 2x takes :func:`_upscale2x`.
    """
    hdim, wdim = dims
    in_h, in_w = x.shape[hdim], x.shape[wdim]
    if height == 2 * in_h and width == 2 * in_w:
        return _upscale2x(x, dims)
    for dim, size in ((hdim, height), (wdim, width)):
        x = _resize_axis(x, dim, *_axis_taps(x.shape[dim], size, x.device))
    return x


def source_rows(in_height, height, start, stop):
    """The rows ``[first, last)`` of a source ``in_height`` rows high that
    rows ``[start, stop)`` of its :func:`resize_bilinear` to ``height``
    rows read, one more on each side (clipped to the source), so that
    taps computed on another device cannot fall outside."""
    lo, hi, _ = _axis_taps(in_height, height, torch.device("cpu"))
    return (max(0, int(lo[start:stop].min()) - 1),
            min(in_height, int(hi[start:stop].max()) + 2))


def resize_rows(x, first, in_height, height, start, stop, width, dims=(1, 2)):
    """Rows ``[start, stop)`` of ``resize_bilinear(X, height, width,
    dims)``, where ``x`` holds rows ``[first, first + n)`` of ``X``
    (``in_height`` rows in all) and at least those that :func:`source_rows`
    names: the taps are the whole image's, so the rows are those of the
    whole resize, bit for bit (a row strip's resize)."""
    hdim, wdim = dims
    if height == 2 * in_height and width == 2 * x.shape[wdim]:
        # The rows at x's own edges are clamped to x's, not the image's,
        # unless they are the image's: source_rows keeps them out of the
        # rows asked for.
        return _upscale2x(x, dims).narrow(hdim, start - 2 * first, stop - start)
    lo, hi, frac = _axis_taps(in_height, height, x.device)
    x = _resize_axis(x, hdim, lo[start:stop] - first, hi[start:stop] - first, frac[start:stop])
    return _resize_axis(x, wdim, *_axis_taps(x.shape[wdim], width, x.device))


def upsample_like(source, target):
    """``source`` (NHWC) resized to the spatial shape of ``target``: the
    reference's ``UpsampleLike`` layer."""
    return resize_bilinear(source, target.shape[1], target.shape[2])


def rgb_to_grayscale(image):
    """ITU-R 601 luma, bit-exact with ``cv2.cvtColor(RGB2GRAY)`` on
    uint8-valued inputs.

    OpenCV's fixed point ``(9798*R + 19235*G + 3735*B + 2**14) >> 15`` in
    elementwise float32: on uint8 values every intermediate is an integer
    below 2**24 and the divide is by a power of two, so ``floor`` lands
    where the shift does. The pipeline also feeds it the upscaled (not
    integer) image, as the JAX package does.
    """
    rgb = image.to(torch.float32)
    acc = rgb[..., 0] * 9798.0 + rgb[..., 1] * 19235.0 + rgb[..., 2] * 3735.0
    return torch.floor((acc + 16384.0) * (1.0 / 32768.0))
