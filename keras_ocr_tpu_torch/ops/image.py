"""Device image ops on NHWC tensors: normalisation, resize, grayscale.

Port of ``keras_ocr_tpu/ops/image.py``. Everything here is elementwise or
two-tap gathers in float32; nothing goes through a matrix product, so no
TF32 path can change the numbers on the card.
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


def _upscale2x(x, dims=(1, 2)):
    """Exact 2x half-pixel-centers bilinear upsample of an NHWC batch
    (``dims`` names the two spatial dimensions of another layout).

    out[2i] = 0.25*in[i-1] + 0.75*in[i]; out[2i+1] = 0.75*in[i] +
    0.25*in[i+1], edge-clamped, per axis.
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


def resize_bilinear(x, height, width, dims=(1, 2)):
    """Bilinear resize with half-pixel centers of an NHWC batch (``dims``
    names the two spatial dimensions of another layout).

    Same sampling as ``keras_ocr_tpu/ops/image.py:resize_bilinear`` (centers
    clipped to the source), written as two-tap gathers per axis instead of
    interpolation matrices.
    """
    hdim, wdim = dims
    in_h, in_w = x.shape[hdim], x.shape[wdim]
    if height == 2 * in_h and width == 2 * in_w:
        return _upscale2x(x, dims)
    for dim, size in ((hdim, height), (wdim, width)):
        lo, hi, frac = _axis_taps(x.shape[dim], size, x.device)
        shape = [1] * x.dim()
        shape[dim] = size
        frac = frac.to(x.dtype).reshape(shape)
        x = (1.0 - frac) * x.index_select(dim, lo) + frac * x.index_select(dim, hi)
    return x


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
