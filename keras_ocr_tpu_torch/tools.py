"""Host image and geometry utilities of the port.

Counterparts of ``keras_ocr_tpu/tools.py`` (``read``, ``pad``,
``resize_image``, ``fit``, ``read_and_fit``, ``polygon_area``,
``convex_hull``, ``min_area_rect``, ``get_perspective_transform``,
``warp_perspective``, ``get_rotated_box``, ``warpBox``, the line
helpers ``flatten``, ``combine_line``, ``adjust_boxes``, ``fix_line``, and
``augment``, which moves boxes through a
:mod:`keras_ocr_tpu_torch.data.augmentation` augmenter with their image,
and the drawing functions ``drawBoxes`` and ``drawAnnotations``)
with numpy and the standard library only (``drawAnnotations`` imports
matplotlib when called). PNG files are decoded by a small
reader: colour types 0, 2, 3, 4 and 6 at every bit depth the format
allows, plain or Adam7-interlaced, to RGB uint8 as PIL's ``convert("RGB")``
gives them. JPEG files (8-bit, grey, three components, CMYK or YCCK;
Huffman-coded sequential or progressive, and through :mod:`.jpeg_modes`
arithmetic-coded sequential or progressive and lossless) are decoded by
:func:`decode_jpeg` with the arithmetic of PIL's libjpeg-turbo, GIF files
by :func:`decode_gif`, TIFF, BMP, PNM, TGA, PCX, ICO and CUR files by
:mod:`.codecs` (:func:`decode_tiff`, :func:`decode_bmp`,
:func:`decode_pnm`, :func:`decode_tga`, :func:`decode_pcx`,
:func:`decode_ico`; DIB and DCX too), WebP files by
:func:`.webp.decode_webp`, JPEG 2000 files by :mod:`.jpeg2000`, and PSD,
QOI, SGI, Sun raster, ICNS, IM, MSP, XBM and XPM files by
:mod:`.rasters`. The
download helpers (``sha256sum``, ``md5sum``, ``get_default_cache_dir``,
``download_and_verify``, ``safe_extract_zip``, ``download_and_extract``)
serve the weight registry (:mod:`.weights`).
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import struct
import typing
import urllib.parse
import urllib.request
import warnings
import zipfile
import zlib

import numpy as np

from .codecs import (CUR_SIGNATURE, PNM_PREFIXES, TIFF_SIGNATURES, cmyk_to_rgb,  # noqa: F401
                     decode_bmp, decode_dcx, decode_dib, decode_ico, decode_pcx, decode_pnm,
                     decode_tga, decode_tiff, is_dcx, is_dib, is_ico, is_pcx, is_tga)
from . import avif, jpeg_modes, rasters
from .jpeg2000 import decode_jpeg2000, is_jpeg2000
from .webp import decode_webp

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# Samples per pixel of each PNG colour type: grey, RGB, palette index,
# grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_URL_RE = re.compile(r"^https?://", re.IGNORECASE)
# The seven Adam7 passes of an interlaced PNG: (x0, y0, dx, dy) of the
# pixels each one holds.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


# ---------------------------------------------------------------------------
# Geometry (cv2.contourArea / minAreaRect + boxPoints, in numpy)
# ---------------------------------------------------------------------------


def polygon_area(points) -> float:
    """Absolute polygon area by the shoelace formula."""
    pts = np.asarray(points, dtype="float64")
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def convex_hull(points) -> np.ndarray:
    """Convex hull (counter-clockwise in xy math coordinates) by Andrew's
    monotone chain."""
    pts = np.unique(np.asarray(points, dtype="float64"), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: typing.List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: typing.List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points) -> np.ndarray:
    """Minimum-area rotated rectangle of a point set, as 4 float32 corners
    in cyclic order (clockwise on screen, y down): convex hull + rotating
    calipers, since the optimal rectangle shares a direction with a hull
    edge."""
    pts = np.asarray(points, dtype="float64").reshape(-1, 2)
    hull = convex_hull(pts)
    if len(hull) == 1:
        return np.tile(hull[0], (4, 1)).astype("float32")
    if len(hull) == 2:
        a, b = hull  # a zero-thickness rectangle along the segment
        return np.array([a, b, b, a], dtype="float32")
    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    best = None
    for theta in np.unique(np.mod(angles, np.pi / 2)):
        c, s = np.cos(theta), np.sin(theta)
        proj = hull @ np.array([[c, s], [-s, c]]).T
        mins, maxs = proj.min(axis=0), proj.max(axis=0)
        area = np.prod(maxs - mins)
        if best is None or area < best[0]:
            best = (area, theta, mins, maxs)
    _, theta, (x0, y0), (x1, y1) = best
    c, s = np.cos(theta), np.sin(theta)
    corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    return (corners @ np.array([[c, s], [-s, c]])).astype("float32")


def get_perspective_transform(src, dst) -> np.ndarray:
    """3x3 homography taking 4 ``src`` points onto 4 ``dst`` points
    (``cv2.getPerspectiveTransform``), by one 8x8 solve."""
    src = np.asarray(src, dtype="float64")
    dst = np.asarray(dst, dtype="float64")
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def warp_perspective(image, M, dsize, cval=0.0):
    """Apply the homography ``M`` (source -> destination) to ``image``;
    ``dsize`` is the output (width, height).

    Each destination pixel samples the source at ``M^-1 @ (x, y, 1)``
    bilinearly in float64, as ``scipy.ndimage.map_coordinates(order=1,
    mode="constant")`` does: a sample outside the closed range [0, n-1] of
    either axis, by any amount, takes ``cval``, and the four taps are
    summed in scipy's order, ``(value * wy) * wx``, so that the sums agree
    bit for bit. Integer images are rounded half to even and clipped back
    to their type.
    """
    width, height = dsize
    Minv = np.linalg.inv(M)
    xs, ys = np.meshgrid(np.arange(width, dtype="float64"), np.arange(height, dtype="float64"))
    denom = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    src_x = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / denom
    src_y = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / denom
    image = np.asarray(image)
    planes = image.astype("float64")
    if image.ndim == 2:
        planes = planes[..., None]
    rows, cols = planes.shape[:2]
    inside = (src_y >= 0) & (src_y <= rows - 1) & (src_x >= 0) & (src_x <= cols - 1)
    y = np.where(inside, src_y, 0.0)
    x = np.where(inside, src_x, 0.0)
    y0 = np.floor(y).astype("int64")
    x0 = np.floor(x).astype("int64")
    # At the last row or column the far tap has weight 0: clamp its index.
    y1 = np.minimum(y0 + 1, rows - 1)
    x1 = np.minimum(x0 + 1, cols - 1)
    wy1 = (y - y0)[..., None]
    wx1 = (x - x0)[..., None]
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    out = (planes[y0, x0] * wy0) * wx0
    out = out + (planes[y0, x1] * wy0) * wx1
    out = out + (planes[y1, x0] * wy1) * wx0
    out = out + (planes[y1, x1] * wy1) * wx1
    out = np.where(inside[..., None], out, cval)
    if image.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(image.dtype)


# ---------------------------------------------------------------------------
# Resize (cv2.resize INTER_LINEAR)
# ---------------------------------------------------------------------------


def _linear_taps(dst: int, src: int):
    """Two-tap source indices and weights per output coordinate: output
    pixel i samples the source at (i + 0.5) * src/dst - 0.5, borders
    replicated, no antialiasing on downscale (cv2 INTER_LINEAR)."""
    x = (np.arange(dst, dtype="float64") + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x).astype("int64")
    frac = x - x0
    return np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1), frac


def _resize(image, width: int, height: int):
    """Separable bilinear resize with cv2.resize INTER_LINEAR semantics;
    integer images are rounded and clipped back to their type."""
    image = np.asarray(image)
    width, height = int(width), int(height)
    if image.shape[0] == height and image.shape[1] == width:
        return image
    arr = image.astype("float64")
    lo, hi, frac = _linear_taps(height, arr.shape[0])
    f = frac.reshape((-1,) + (1,) * (arr.ndim - 1))
    arr = arr[lo] * (1.0 - f) + arr[hi] * f
    lo, hi, frac = _linear_taps(width, arr.shape[1])
    f = frac.reshape((1, -1) + (1,) * (arr.ndim - 2))
    arr = arr[:, lo] * (1.0 - f) + arr[:, hi] * f
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        arr = np.clip(np.rint(arr), info.min, info.max)
    return arr.astype(image.dtype)


def resize_image(image, max_scale, max_size):
    """Resize by ``max_scale`` unless that puts the longest side past
    ``max_size``, then to ``max_size``; returns (image, scale)."""
    scale = min(max_scale, max_size / max(image.shape))
    resized = _resize(
        image, width=int(image.shape[1] * scale), height=int(image.shape[0] * scale)
    )
    return resized, scale


def fit(image, width: int, height: int, cval: int = 255, mode="letterbox", return_scale=False):
    """Fit an image to (height, width): ``letterbox`` scales by the tighter
    axis and fills the rest with ``cval`` (the output is then 3-channel
    uint8); ``crop`` scales by the looser axis and trims the overflow. The
    other side's extent is truncated to an int; an image already of the
    size passes as it is."""
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (height, width):
        return (image, 1) if return_scale else image
    if mode not in ("letterbox", "crop"):
        raise NotImplementedError(f"Unsupported mode: {mode}")
    width_scale = width / src_w
    height_scale = height / src_h
    if (width_scale <= height_scale) if mode == "letterbox" else (width_scale >= height_scale):
        scale = width_scale
        resized = _resize(image, width=width, height=int(width_scale * src_h))
    else:
        scale = height_scale
        resized = _resize(image, width=int(height_scale * src_w), height=height)
    if mode == "crop":
        fitted = resized[:height, :width]
    else:
        fitted = np.full((height, width, 3), cval, dtype="uint8")
        visible = resized[:height, :width]
        fitted[: visible.shape[0], : visible.shape[1]] = visible
    return (fitted, scale) if return_scale else fitted


# ---------------------------------------------------------------------------
# Image IO
# ---------------------------------------------------------------------------


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (PNG spec, section 9) of rows of
    ``stride`` bytes, ``bpp`` bytes a pixel (at least 1)."""
    data = np.frombuffer(raw, dtype=np.uint8)[: height * (stride + 1)]
    data = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.int32)
    for row in range(height):
        kind = data[row, 0]
        line = data[row, 1:].astype(np.int32)
        if kind == 0:
            recon = line
        elif kind == 1:  # Sub: serial dependency along the row
            recon = line.copy()
            for i in range(bpp, stride):
                recon[i] = (recon[i] + recon[i - bpp]) & 0xFF
        elif kind == 2:  # Up
            recon = (line + prior) & 0xFF
        elif kind == 3:  # Average
            recon = line.copy()
            for i in range(stride):
                left = recon[i - bpp] if i >= bpp else 0
                recon[i] = (recon[i] + ((left + prior[i]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            recon = line.copy()
            for i in range(stride):
                a = recon[i - bpp] if i >= bpp else 0
                b = prior[i]
                c = prior[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                recon[i] = (recon[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {row}")
        out[row] = recon
        prior = recon
    return out


def _stride(width: int, channels: int, depth: int) -> int:
    """Bytes of a scanline's samples (without its filter byte)."""
    return (width * channels * depth + 7) // 8


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> (H, W, channels) samples (uint8, or uint16
    at depth 16)."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    if depth == 8:
        return rows.reshape(height, width, channels)
    # Sub-byte depths (one channel): unpack, leftmost sample first.
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = (bits * weights).sum(-1).astype(np.uint8)
    return values[:, :width, None]


def decode_png(blob: bytes, name: str = "image") -> np.ndarray:
    """Decode a PNG, plain or Adam7-interlaced, into (H, W, 3) uint8, as PIL's
    ``Image.open(...).convert("RGB")`` gives it: alpha is dropped, grey is
    repeated over the three channels, a palette is looked up, grey of 1-4
    bits is scaled to 0-255, 16-bit grey is clipped to 255 and 16-bit
    colour keeps its high byte."""
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos = 8
    header = palette = None
    idat = []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name} has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f"{name}: invalid PNG colour type {color} at depth {depth}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    try:  # as PIL's streaming inflate, a stream cut after the last row is read
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as error:
        raise ValueError(f"{name}: corrupt PNG image data ({error})") from None
    bpp = max(1, channels * depth // 8)
    if interlace == 0:
        stride = _stride(width, channels, depth)
        if len(raw) < height * (stride + 1):
            raise ValueError(f"{name}: truncated PNG image data")
        samples = _samples(_unfilter(raw, height, stride, bpp), width, channels, depth)
    else:
        samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            # A pass of a small image may hold no pixel: then it has no
            # scanline, not even a filter byte. Each pass is filtered alone.
            sub_w, sub_h = _ceil_div(width - x0, dx), _ceil_div(height - y0, dy)
            if sub_w <= 0 or sub_h <= 0:
                continue
            stride = _stride(sub_w, channels, depth)
            size = sub_h * (stride + 1)
            if pos + size > len(raw):
                raise ValueError(f"{name}: truncated PNG image data")
            rows = _unfilter(raw[pos : pos + size], sub_h, stride, bpp)
            samples[y0::dy, x0::dx] = _samples(rows, sub_w, channels, depth)
            pos += size
    if color == 3:
        return np.ascontiguousarray(palette[samples[..., 0]])
    if depth == 16:
        if color in (0, 4):
            # PIL opens 16-bit grey as "I;16", whose RGB conversion clips;
            # grey + alpha it reads by the high byte, as it does colour.
            grey = samples[..., 0]
            samples = (np.minimum(grey, 255) if color == 0 else grey >> 8)[..., None]
        else:
            samples = samples >> 8
        samples = samples.astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if color in (0, 4):
        return np.ascontiguousarray(np.repeat(samples[..., :1], 3, axis=-1))
    return np.ascontiguousarray(samples[..., :3])


# JPEG: the decoder PIL's libjpeg-turbo runs with its defaults (the islow
# integer IDCT, fancy upsampling, the fixed-point YCbCr tables), in numpy.
# Only the entropy decode is a Python loop; the rest runs over all blocks.


_NATURAL = jpeg_modes.NATURAL
# The frame types this decoder refuses, by SOF marker: PIL's libjpeg-turbo
# refuses them too (it has no hierarchical and no arithmetic-coded
# lossless decoder).
_UNSUPPORTED_SOF = {
    0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
}
# The frame types decoded, by SOF marker: (coding, progressive, lossless).
_SOF_KINDS = {0xC0: ("huffman", False, False), 0xC1: ("huffman", False, False),
              0xC2: ("huffman", True, False), 0xC3: ("huffman", False, True),
              0xC9: ("arithmetic", False, False), 0xCA: ("arithmetic", True, False)}
# libjpeg's limits: sampling factors 1-4, at most 10 blocks (a lossless
# frame: samples) in an interleaved MCU.
_MAX_SAMPLING, _MAX_BLOCKS_IN_MCU = 4, 10


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _idct_range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by the descaled value & 1023:
    adds 128 and clamps to 0-255, wrapping only past +-512."""
    table = np.empty(1024, np.uint8)
    table[:128] = np.arange(128, 256)
    table[128:512] = 255
    table[512:896] = 0
    table[896:] = np.arange(128)
    return table


_RANGE_LIMIT = _idct_range_limit()


def _idct_1d(c, shift):
    """One pass of ``jidctint.c:jpeg_idct_islow`` (CONST_BITS 13) on eight
    int64 arrays of coefficients; returns the eight outputs descaled by
    ``shift`` bits with rounding."""
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 + c[6] * -15137
    tmp3 = z1 + c[2] * 6270
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [
        (tmp10 + t3 + half) >> shift, (tmp11 + t2 + half) >> shift,
        (tmp12 + t1 + half) >> shift, (tmp13 + t0 + half) >> shift,
        (tmp13 - t0 + half) >> shift, (tmp12 - t1 + half) >> shift,
        (tmp11 - t2 + half) >> shift, (tmp10 - t3 + half) >> shift,
    ]


def _idct_blocks(coefs: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) uint8 samples: the
    column pass (PASS1_BITS 2), the row pass, the range limit."""
    work = np.stack(_idct_1d([coefs[:, k, :] for k in range(8)], 13 - 2), axis=1)
    rows = _idct_1d([work[:, :, k] for k in range(8)], 13 + 2 + 3)
    return _RANGE_LIMIT[np.stack(rows, axis=-1) & 1023]


def _huffman_lut(counts, symbols, name) -> list:
    """Canonical Huffman codes as a table of the next 16 bits: entry =
    code length << 8 | symbol, 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    code = index = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError(f"{name}: corrupt JPEG: bad Huffman table")
            shift = 16 - length
            lut[code << shift : (code + 1) << shift] = (length << 8) | symbols[index]
            code += 1
            index += 1
        code <<= 1
    return lut.tolist()


def _decode_interval(data, blocks, name):
    """Entropy-decode the blocks of one restart interval from its unstuffed
    bytes. ``blocks`` holds (coefficients, base, DC table, AC table,
    predictor slot, predictors) per block in stream order; coefficients
    land in natural order at ``base``."""
    win = jpeg_modes.windows(data)
    natural = _NATURAL
    pos = 0
    for coefs, base, dc, ac, slot, preds in blocks:
        w = win[pos >> 3]
        avail = 40 - (pos & 7)
        entry = dc[(w >> (avail - 16)) & 0xFFFF]
        if not entry:
            raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        length, size = entry >> 8, entry & 0xFF
        if size:
            if size > 16:
                raise ValueError(f"{name}: corrupt JPEG: DC difference of {size} bits")
            value = (w >> (avail - length - size)) & ((1 << size) - 1)
            if value < 1 << (size - 1):
                value -= (1 << size) - 1
            preds[slot] += value
        pos += length + size
        coefs[base] = preds[slot]
        k = 1
        while k < 64:
            w = win[pos >> 3]
            avail = 40 - (pos & 7)
            entry = ac[(w >> (avail - 16)) & 0xFFFF]
            if not entry:
                raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
            length, rs = entry >> 8, entry & 0xFF
            size = rs & 15
            if size:
                k += rs >> 4
                value = (w >> (avail - length - size)) & ((1 << size) - 1)
                if value < 1 << (size - 1):
                    value -= (1 << size) - 1
                coefs[base + natural[k]] = value
                pos += length + size
                k += 1
            else:
                pos += length
                if rs != 0xF0:
                    break
                k += 16
    if pos > 8 * len(data):
        raise ValueError(f"{name}: truncated JPEG: the scan data ends inside a block")


def _scan_data_end(blob: bytes, start: int) -> int:
    """Offset of the first marker after ``start`` that is neither a stuffed
    0xFF00 nor a restart marker."""
    pos = start
    while True:
        pos = blob.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(blob):
            return len(blob)
        follower = blob[pos + 1]
        if follower != 0 and not 0xD0 <= follower <= 0xD7:
            return pos
        pos += 2


def _upsample(plane, rh, rv, width, height, fancy=True):
    """A component plane of (ceil(height / rv), ceil(width / rh)) real
    samples to (height, width), by the method libjpeg-turbo's
    ``jdsample.c:jinit_upsampler`` picks for the integral ratio (rh, rv):
    none at (1, 1); with fancy upsampling the h2v1 and h2v2 triangle
    filters (h2v2 with its alternating +8/+7 bias) on planes wider than 2
    samples, box replication on narrower ones, and the h1v2 filter; box
    replication (``int_upsample``) at every other ratio, and at every
    ratio without ``fancy`` (a lossless frame). Neighbours past an edge
    repeat the edge."""
    if (rh, rv) == (1, 1):
        return plane[:height, :width]
    x = plane.astype(np.int32)
    wide = x.shape[1] > 2
    if fancy and (rh, rv) == (1, 2):
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out[:height, :width].astype(np.uint8)
    if fancy and wide and (rh, rv) == (2, 2):
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        sums = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
        sums[0::2] = 3 * x + above
        sums[1::2] = 3 * x + below
        left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
        out = np.empty((sums.shape[0], 2 * sums.shape[1]), np.int32)
        out[:, 0::2] = (3 * sums + left + 8) >> 4
        out[:, 1::2] = (3 * sums + right + 7) >> 4
        return out[:height, :width].astype(np.uint8)
    if fancy and wide and (rh, rv) == (2, 1):
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out[:height, :width].astype(np.uint8)
    return np.repeat(np.repeat(plane, rv, 0), rh, 1)[:height, :width]


def _ycc_to_rgb(y, cb, cr):
    """``jdcolor.c:ycc_rgb_convert`` (SCALEBITS 16, rounded table entries),
    clamped to 0-255."""
    one_half = 1 << 15
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    red = y + ((91881 * cr + one_half) >> 16)
    green = y + ((-22554 * cb + one_half - 46802 * cr) >> 16)
    blue = y + ((116130 * cb + one_half) >> 16)
    return np.clip(np.stack([red, green, blue], -1), 0, 255).astype(np.uint8)


def decode_jpeg(blob: bytes, name: str = "image") -> np.ndarray:
    """Decode an 8-bit JPEG of 1, 3 or 4 components into (H, W, 3) uint8
    as PIL's ``Image.open(...).convert("RGB")`` gives it: Huffman-coded
    (SOF0 baseline, SOF1 extended sequential, SOF2 progressive),
    arithmetic-coded (SOF9 sequential, SOF10 progressive, with ``DAC``
    conditioning; :mod:`.jpeg_modes`) or lossless (SOF3, predictors 1-7,
    point transform; :mod:`.jpeg_modes`), at sampling factors 1-4 whose
    ratios to the largest are integers, at most 10 blocks (samples) in an
    MCU. DCT
    frames take libjpeg-turbo's islow IDCT, its upsampling (the fancy h2v1,
    h2v2 and h1v2 filters at a ratio of 2, box replication at the others)
    and YCbCr tables; a lossless frame's samples are box-replicated and
    never colour-converted (libjpeg-turbo refuses a lossless frame whose
    JFIF or Adobe marker asks for a conversion, and so does this). Grey is
    repeated over three
    channels; no colour conversion for an Adobe transform 0 or component
    ids R, G, B (a JFIF marker means YCbCr). Four components are CMYK
    (Adobe transform 0, or no Adobe marker) or YCCK (any other transform:
    YCbCr to RGB on the first three, inverted, as libjpeg's
    ``ycck_cmyk_convert``); PIL reads them in Adobe's inverted polarity
    (raw mode ``CMYK;I``) and converts with
    :func:`keras_ocr_tpu_torch.codecs.cmyk_to_rgb`. The EXIF orientation is
    not applied, as PIL's ``open`` does not.

    A progressive file's scans (DC first and refinement, AC spectral bands
    with successive approximation and EOB runs, restart intervals) fill the
    coefficients; they then take the sequential path, as libjpeg's output
    does once the whole file is read (no block smoothing: every coefficient
    is complete).

    Raises NotImplementedError naming the kind of what PIL's
    libjpeg-turbo does not read either: a hierarchical (SOF5-7, SOF13-15)
    or arithmetic-coded lossless (SOF11) frame, a precision other than 8
    bits, a DNL-defined height, 2 components, a sampling factor above 4, a
    fractional upsampling ratio, more than 10 blocks (lossless: samples)
    in an MCU, a lossless
    frame to colour-convert or with restart intervals that are not whole
    MCU rows; and ValueError on a truncated or corrupt stream (a corrupt
    arithmetic-coded stream too, which libjpeg-turbo decodes with a
    warning).
    """
    return _assemble(*_jpeg_frame(blob, name), name)


def _jpeg_frame(blob: bytes, name: str):
    """Read a JPEG stream's markers and scans: (the frame with each
    component's decoded coefficients, whether a JFIF marker came, the
    Adobe marker's transform or None)."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{name} is not a JPEG file")
    quant, tables, conditioning = {}, {}, {}
    frame = None
    restart = 0
    jfif = False
    adobe_transform = None
    scans = 0
    pos = 2
    while True:
        if pos >= len(blob):
            raise ValueError(f"{name}: truncated JPEG: no EOI marker")
        if blob[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG: no marker at byte {pos}")
        while pos < len(blob) and blob[pos] == 0xFF:
            pos += 1
        if pos >= len(blob):
            raise ValueError(f"{name}: truncated JPEG: no EOI marker")
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(blob):
            raise ValueError(f"{name}: truncated JPEG in a marker segment")
        (length,) = struct.unpack(">H", blob[pos : pos + 2])
        segment = blob[pos + 2 : pos + length]
        if length < 2 or len(segment) != length - 2:
            raise ValueError(f"{name}: truncated JPEG in a marker segment")
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(
                f"{name}: {_UNSUPPORTED_SOF[marker]} JPEG (SOF{marker - 0xC0}) is not supported"
            )
        if marker == 0xCC:
            jpeg_modes.parse_dac(segment, conditioning, name)
        elif marker == 0xE0 and segment[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and segment[:5] == b"Adobe" and len(segment) >= 12:
            adobe_transform = segment[11]
        elif marker == 0xDB:
            frame_pos = 0
            while frame_pos < len(segment):
                precision, table_id = segment[frame_pos] >> 4, segment[frame_pos] & 15
                size = 128 if precision else 64
                body = segment[frame_pos + 1 : frame_pos + 1 + size]
                if len(body) != size or table_id > 3:
                    raise ValueError(f"{name}: corrupt JPEG: bad DQT segment")
                values = np.frombuffer(body, ">u2" if precision else np.uint8).astype(np.int64)
                natural = np.zeros(64, np.int64)
                natural[_NATURAL[:64]] = values
                quant[table_id] = natural.reshape(8, 8)
                frame_pos += 1 + size
        elif marker == 0xC4:
            frame_pos = 0
            while frame_pos < len(segment):
                if frame_pos + 17 > len(segment):
                    raise ValueError(f"{name}: corrupt JPEG: bad DHT segment")
                kind, table_id = segment[frame_pos] >> 4, segment[frame_pos] & 15
                counts = list(segment[frame_pos + 1 : frame_pos + 17])
                symbols = segment[frame_pos + 17 : frame_pos + 17 + sum(counts)]
                if kind > 1 or table_id > 3 or len(symbols) != sum(counts):
                    raise ValueError(f"{name}: corrupt JPEG: bad DHT segment")
                tables[kind, table_id] = _huffman_lut(counts, symbols, name)
                frame_pos += 17 + sum(counts)
        elif marker == 0xDD:
            if len(segment) < 2:
                raise ValueError(f"{name}: corrupt JPEG: bad DRI segment")
            (restart,) = struct.unpack(">H", segment[:2])
        elif marker in _SOF_KINDS:
            frame = _read_frame(segment, name, *_SOF_KINDS[marker])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: corrupt JPEG: a scan before the frame header")
            if frame["lossless"] and not scans:
                _check_lossless_colour(frame, jfif, adobe_transform, name)
            end = _scan_data_end(blob, pos)
            _decode_scan(frame, segment, blob[pos:end], quant, tables, restart, name,
                         conditioning)
            scans += 1
            pos = end
    if frame is None or not scans:
        raise ValueError(f"{name}: corrupt JPEG: no frame or no scan")
    return frame, jfif, adobe_transform


def _read_frame(segment, name, coding="huffman", progressive=False, lossless=False):
    """A SOF header: image size and, per component, its id, sampling
    factors and block grid (padded to whole MCUs), with the frame's
    entropy coding and kind."""
    if len(segment) < 6:
        raise ValueError(f"{name}: corrupt JPEG: bad SOF segment")
    precision, height, width, count = struct.unpack(">BHHB", segment[:6])
    if precision != 8:
        raise NotImplementedError(f"{name}: {precision}-bit JPEG is not supported")
    if count not in (1, 3, 4) or len(segment) < 6 + 3 * count:
        raise NotImplementedError(f"{name}: {count}-component JPEG is not supported")
    if height == 0 or width == 0:
        raise NotImplementedError(f"{name}: JPEG with a DNL-defined or zero size")
    components = []
    for i in range(count):
        ident, sampling, table = segment[6 + 3 * i : 9 + 3 * i]
        components.append({"id": ident, "h": sampling >> 4, "v": sampling & 15, "quant": table})
    factors = [(c["h"], c["v"]) for c in components]
    if not all(1 <= f <= _MAX_SAMPLING for pair in factors for f in pair):
        raise NotImplementedError(f"{name}: JPEG sampling factors {factors} (libjpeg reads "
                                  f"1-{_MAX_SAMPLING})")
    hmax = max(c["h"] for c in components)
    vmax = max(c["v"] for c in components)
    if any(hmax % h or vmax % v for h, v in factors):
        raise NotImplementedError(f"{name}: JPEG sampling factors {factors}: a fractional "
                                  "upsampling ratio (libjpeg does not read it)")
    unit = 1 if lossless else 8
    mcus_x = _ceil_div(width, unit * hmax)
    mcus_y = _ceil_div(height, unit * vmax)
    for c in components:
        c["blocks"] = (mcus_y * c["v"], mcus_x * c["h"])
        c["coefs"] = None if lossless else [0] * (mcus_y * c["v"] * mcus_x * c["h"] * 64)
        c["q"] = c["samples"] = None
    return {"width": width, "height": height, "hmax": hmax, "vmax": vmax,
            "mcus": (mcus_y, mcus_x), "components": components, "progressive": progressive,
            "coding": coding, "lossless": lossless}


def _check_lossless_colour(frame, jfif, adobe_transform, name):
    """libjpeg-turbo converts no colours in a lossless frame: three
    components under a JFIF marker (YCbCr), or three or four under an
    Adobe transform other than 0 (YCbCr, YCCK), are refused."""
    count = len(frame["components"])
    if count > 1 and ((jfif and count == 3) or adobe_transform not in (None, 0)):
        source = "a JFIF marker" if jfif and count == 3 else f"Adobe transform {adobe_transform}"
        raise NotImplementedError(f"{name}: lossless JPEG with {source}, which asks for a colour "
                                  "conversion (libjpeg-turbo does not convert a lossless frame)")


def _decode_scan(frame, header, data, quant, tables, restart, name, conditioning=None):
    """Decode one scan: its components interleaved in MCUs, or one
    component in its own block grid. A sequential scan carries whole
    blocks; a progressive one (SOF2, SOF10) carries the DC coefficient or a
    band ``Ss``-``Se`` of AC coefficients, first at bit ``Al`` (``Ah`` 0)
    or as one refinement bit of it (``Ah`` = ``Al`` + 1), as ``jdphuff.c``
    and ``jdarith.c`` decode them; a lossless scan (SOF3) carries samples'
    prediction differences (:func:`.jpeg_modes.lossless_scan`)."""
    count = header[0] if header else 0
    if not 1 <= count <= len(frame["components"]) or len(header) < 1 + 2 * count + 3:
        raise ValueError(f"{name}: corrupt JPEG: bad SOS segment")
    start, end, approx = header[1 + 2 * count : 4 + 2 * count]
    high, low = approx >> 4, approx & 15
    by_id = {c["id"]: c for c in frame["components"]}
    # libjpeg's per_scan_setup holds a lossless scan's samples to the same
    # limit as a DCT scan's blocks.
    named = [by_id.get(header[1 + 2 * slot]) for slot in range(count)]
    if count > 1 and sum(c["h"] * c["v"] for c in named if c) > _MAX_BLOCKS_IN_MCU:
        raise NotImplementedError(f"{name}: JPEG scan of more than {_MAX_BLOCKS_IN_MCU} "
                                  "blocks (lossless: samples) in an MCU (libjpeg does not "
                                  "read it)")
    if frame["lossless"]:
        _lossless_scan(frame, header, count, data, tables, restart, name, by_id)
        return
    arithmetic = frame["coding"] == "arithmetic"
    conditioning = conditioning or {}
    progressive = frame["progressive"]
    if progressive and (
        (start == 0 and end != 0) or (start > 0 and (count != 1 or not start <= end <= 63))
        or low > 13 or (high and high != low + 1)
    ):
        raise ValueError(f"{name}: corrupt JPEG: bad progressive scan parameters "
                         f"Ss={start} Se={end} Ah={high} Al={low}")
    # The tables this scan reads: DC for a sequential scan and a first DC
    # scan, AC for a sequential scan and any AC scan; none for DC refinement.
    need_dc = not progressive or (start == 0 and high == 0)
    need_ac = not progressive or start > 0
    members = []
    preds = [0] * count
    for slot in range(count):
        ident, selectors = header[1 + 2 * slot : 3 + 2 * slot]
        component = by_id.get(ident)
        if arithmetic:  # statistics tables, conditioned by DAC
            dc = (selectors >> 4, *conditioning.get((0, selectors >> 4), (0, 1)))
            ac = (selectors & 15, conditioning.get((1, selectors & 15), 5))
        else:
            dc, ac = tables.get((0, selectors >> 4)), tables.get((1, selectors & 15))
        if component is None or (need_dc and dc is None) or (need_ac and ac is None):
            raise ValueError(f"{name}: corrupt JPEG: a scan names a missing component or table")
        if component["q"] is None:
            if component["quant"] not in quant:
                raise ValueError(f"{name}: corrupt JPEG: no quantisation table")
            component["q"] = quant[component["quant"]]
        members.append((component, dc, ac, slot))
    order = []
    if count == 1:
        component, dc, ac, slot = members[0]
        grid_w = component["blocks"][1]
        rows = _ceil_div(_ceil_div(frame["height"] * component["v"], frame["vmax"]), 8)
        cols = _ceil_div(_ceil_div(frame["width"] * component["h"], frame["hmax"]), 8)
        for by in range(rows):
            for bx in range(cols):
                order.append([(component["coefs"], (by * grid_w + bx) * 64, dc, ac, slot, preds)])
    else:
        mcus_y, mcus_x = frame["mcus"]
        for my in range(mcus_y):
            for mx in range(mcus_x):
                mcu = []
                for component, dc, ac, slot in members:
                    grid_w = component["blocks"][1]
                    for v in range(component["v"]):
                        for h in range(component["h"]):
                            block = (my * component["v"] + v) * grid_w + mx * component["h"] + h
                            mcu.append((component["coefs"], block * 64, dc, ac, slot, preds))
                order.append(mcu)
    if arithmetic and not progressive:
        decode = jpeg_modes.arith_sequential
    elif arithmetic and start == 0:
        decode = functools.partial(jpeg_modes.arith_dc_refine if high else
                                   jpeg_modes.arith_dc_first, low=low)
    elif arithmetic:
        decode = functools.partial(jpeg_modes.arith_ac_refine if high else
                                   jpeg_modes.arith_ac_first, start=start, end=end, low=low)
    elif not progressive:
        decode = _decode_interval
    elif start == 0:
        decode = functools.partial(_decode_dc_interval, refine=high > 0, low=low)
    else:
        decode = functools.partial(_decode_ac_first if high == 0 else _decode_ac_refine,
                                   start=start, end=end, low=low)
    per_interval = restart or len(order)
    pieces = re.split(rb"\xff[\xd0-\xd7]", data) if restart else [data]
    intervals = _ceil_div(len(order), per_interval)
    if len(pieces) < intervals:
        raise ValueError(f"{name}: truncated JPEG: {len(pieces)} of {intervals} restart intervals")
    for i in range(intervals):
        # A restart interval starts afresh: DC predictions, the EOB run and
        # the bit position (arithmetic coding: the statistics too).
        preds[:] = [0] * count
        blocks = [b for mcu in order[i * per_interval : (i + 1) * per_interval] for b in mcu]
        decode(pieces[i].replace(b"\xff\x00", b"\xff"), blocks, name)


def _lossless_scan(frame, header, count, data, tables, restart, name, by_id):
    """A lossless scan's components and DC Huffman tables, predictor
    (``Ss``, 1-7) and point transform (``Al``), decoded by
    :func:`.jpeg_modes.lossless_scan`."""
    predictor, end, approx = header[1 + 2 * count : 4 + 2 * count]
    if not 1 <= predictor <= 7 or end or approx >> 4 or (approx & 15) >= 8:
        raise ValueError(f"{name}: corrupt JPEG: bad lossless scan parameters Ss={predictor} "
                         f"Se={end} Ah={approx >> 4} Al={approx & 15}")
    members = []
    for slot in range(count):
        ident, selectors = header[1 + 2 * slot : 3 + 2 * slot]
        component, table = by_id.get(ident), tables.get((0, selectors >> 4))
        if component is None or table is None:
            raise ValueError(f"{name}: corrupt JPEG: a scan names a missing component or table")
        members.append((component, table))
    pieces = re.split(rb"\xff[\xd0-\xd7]", data) if restart else [data]
    jpeg_modes.lossless_scan(frame, members, predictor, approx & 15,
                             [p.replace(b"\xff\x00", b"\xff") for p in pieces], restart, name)


def _receive(win, pos, size):
    """The ``size``-bit value at bit ``pos``, sign-extended as a JPEG
    magnitude category (``HUFF_EXTEND``)."""
    w = win[pos >> 3]
    value = (w >> (40 - (pos & 7) - size)) & ((1 << size) - 1)
    return value - (1 << size) + 1 if value < 1 << (size - 1) else value


def _huffman(win, pos, table, name):
    """(code length, symbol) of the Huffman code at bit ``pos``."""
    entry = table[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
    if not entry:
        raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
    return entry >> 8, entry & 0xFF


def _bit(win, pos):
    return (win[pos >> 3] >> (39 - (pos & 7))) & 1


def _check_end(pos, data, name):
    if pos > 8 * len(data):
        raise ValueError(f"{name}: truncated JPEG: the scan data ends inside a block")


def _decode_dc_interval(data, blocks, name, refine, low):
    """A progressive DC scan's restart interval: the first scan adds each
    block's difference to its component's prediction and stores it shifted
    up by ``low``; a refinement scan ORs one bit at ``low`` into it."""
    win = jpeg_modes.windows(data)
    pos = 0
    if refine:
        bit = 1 << low
        for coefs, base, _, _, _, _ in blocks:
            if _bit(win, pos):
                coefs[base] |= bit
            pos += 1
    else:
        for coefs, base, dc, _, slot, preds in blocks:
            length, size = _huffman(win, pos, dc, name)
            pos += length
            if size:
                if size > 16:
                    raise ValueError(f"{name}: corrupt JPEG: DC difference of {size} bits")
                preds[slot] += _receive(win, pos, size)
                pos += size
            coefs[base] = preds[slot] << low
    _check_end(pos, data, name)


def _decode_ac_first(data, blocks, name, start, end, low):
    """A first progressive AC scan's restart interval over the band
    ``start``-``end`` of one component: coefficients shifted up by
    ``low``, and EOB runs that end the band in several blocks at once."""
    win = jpeg_modes.windows(data)
    natural = _NATURAL
    pos = eob_run = 0
    for coefs, base, _, ac, _, _ in blocks:
        if eob_run:
            eob_run -= 1
            continue
        k = start
        while k <= end:
            length, rs = _huffman(win, pos, ac, name)
            pos += length
            run, size = rs >> 4, rs & 15
            if size:
                k += run
                coefs[base + natural[k]] = _receive(win, pos, size) << low
                pos += size
            elif run == 15:
                k += 15
            else:
                eob_run = 1 << run
                if run:
                    eob_run += (win[pos >> 3] >> (40 - (pos & 7) - run)) & ((1 << run) - 1)
                    pos += run
                eob_run -= 1
                break
            k += 1
    _check_end(pos, data, name)


def _decode_ac_refine(data, blocks, name, start, end, low):
    """A progressive AC refinement scan's restart interval: each
    coefficient of the band that is already nonzero takes one correction
    bit (1: its magnitude grows by ``1 << low``), and new coefficients of
    magnitude ``1 << low`` appear after their runs of still-zero ones."""
    win = jpeg_modes.windows(data)
    natural = _NATURAL
    plus, minus = 1 << low, -1 << low
    pos = eob_run = 0
    for coefs, base, _, ac, _, _ in blocks:
        k = start
        if not eob_run:
            while k <= end:
                length, rs = _huffman(win, pos, ac, name)
                pos += length
                run, size = rs >> 4, rs & 15
                value = 0
                if size:
                    # A new coefficient is always of magnitude 1 << low.
                    value = plus if _bit(win, pos) else minus
                    pos += 1
                elif run != 15:
                    eob_run = 1 << run
                    if run:
                        eob_run += (win[pos >> 3] >> (40 - (pos & 7) - run)) & ((1 << run) - 1)
                        pos += run
                    break
                # Pass over the nonzero coefficients (each takes a correction
                # bit) and ``run`` zero ones, stopping at the zero one after.
                while k <= end:
                    index = base + natural[k]
                    coef = coefs[index]
                    if coef:
                        if _bit(win, pos) and not coef & plus:
                            coefs[index] = coef + (plus if coef >= 0 else minus)
                        pos += 1
                    else:
                        run -= 1
                        if run < 0:
                            break
                    k += 1
                if value:
                    coefs[base + natural[k]] = value
                k += 1
        if eob_run:
            # The rest of the band: correction bits for the nonzero ones.
            while k <= end:
                index = base + natural[k]
                coef = coefs[index]
                if coef:
                    if _bit(win, pos) and not coef & plus:
                        coefs[index] = coef + (plus if coef >= 0 else minus)
                    pos += 1
                k += 1
            eob_run -= 1
    _check_end(pos, data, name)


def _jpeg_planes(frame, name) -> list:
    """Dequantise, IDCT and upsample the decoded coefficients: one uint8
    plane of the image's size per component."""
    width, height = frame["width"], frame["height"]
    planes = []
    for c in frame["components"]:
        rh, rv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if frame["lossless"]:
            if c["samples"] is None:
                raise ValueError(f"{name}: corrupt JPEG: component {c['id']} is in no scan")
            planes.append(_upsample(c["samples"], rh, rv, width, height, fancy=False))
            continue
        if c["q"] is None:
            raise ValueError(f"{name}: corrupt JPEG: component {c['id']} is in no scan")
        rows, cols = c["blocks"]
        coefs = np.array(c["coefs"], np.int64).reshape(rows * cols, 8, 8) * c["q"]
        samples = _idct_blocks(coefs).reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
        samples = samples.reshape(rows * 8, cols * 8)
        real = samples[: _ceil_div(height, rv), : _ceil_div(width, rh)]
        planes.append(_upsample(real, rh, rv, width, height))
    return planes


def _assemble(frame, jfif, adobe_transform, name):
    """The decoded coefficients as RGB, converted as libjpeg and PIL
    convert them."""
    planes = _jpeg_planes(frame, name)
    if len(planes) == 1:
        return np.ascontiguousarray(np.repeat(planes[0][..., None], 3, axis=-1))
    if frame["lossless"]:  # RGB or CMYK as stored (_check_lossless_colour)
        if len(planes) == 4:
            return cmyk_to_rgb(255 - np.stack(planes, -1))
        return np.ascontiguousarray(np.stack(planes, -1))
    if len(planes) == 4:
        if adobe_transform not in (None, 0):
            planes[:3] = np.moveaxis(255 - _ycc_to_rgb(*planes[:3]), -1, 0)
        return cmyk_to_rgb(255 - np.stack(planes, -1))
    ids = tuple(c["id"] for c in frame["components"])
    if jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.ascontiguousarray(np.stack(planes, -1))
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# GIF (the first frame, as PIL's GifImagePlugin opens it)
# ---------------------------------------------------------------------------


def _gif_palette(raw: bytes):
    """A colour table as an (n, 3) uint8 array, or None where it is the
    grey ramp ``(i, i, i)`` (PIL then opens the image in mode ``L``, whose
    value is the index itself)."""
    table = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(table), dtype=np.uint8)[:, None]
    return None if np.array_equal(table, np.broadcast_to(ramp, table.shape)) else table


def _gif_sub_blocks(blob: bytes, pos: int, name: str) -> typing.Tuple[bytes, int]:
    """The data of the sub-blocks starting at ``pos`` and the offset after
    their zero-length terminator."""
    parts = []
    while True:
        if pos >= len(blob):
            raise ValueError(f"{name}: truncated GIF in a data block")
        size = blob[pos]
        if not size:
            return b"".join(parts), pos + 1
        if pos + 1 + size > len(blob):
            raise ValueError(f"{name}: truncated GIF in a data block")
        parts.append(blob[pos + 1 : pos + 1 + size])
        pos += 1 + size


def _gif_lzw(data: bytes, min_size: int, count: int, name: str) -> bytes:
    """The first ``count`` indices of a GIF LZW stream: codes LSB first,
    ``min_size + 1`` bits after each clear code, one more bit each time the
    next free code reaches the width's limit, at most 12; a full table
    (4096 codes) stays as it is until a clear code (the deferred clear),
    and a code equal to the next free one is the previous string plus its
    own first index (KwKwK). Raises ``ValueError`` on an undefined code and
    where the stream ends, or its end code comes, before ``count``."""
    clear = 1 << min_size
    end = clear + 1
    roots = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(roots)
    size = min_size + 1
    mask = (1 << size) - 1
    out = []
    produced = 0
    prev = None
    acc = nbits = pos = 0
    length = len(data)
    while produced < count:
        while nbits < size:
            if pos >= length:
                raise ValueError(f"{name}: truncated GIF: the image data ends after "
                                 f"{produced} of {count} pixels")
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & mask
        acc >>= size
        nbits -= size
        if code == clear:
            del table[end + 1 :]
            size = min_size + 1
            mask = (1 << size) - 1
            prev = None
            continue
        if code == end:
            raise ValueError(f"{name}: corrupt GIF: the end code after {produced} of "
                             f"{count} pixels")
        if prev is None:
            if code >= clear:
                raise ValueError(f"{name}: corrupt GIF: code {code} after a clear code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"{name}: corrupt GIF: code {code} past the table "
                                 f"({len(table)} entries)")
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == mask + 1 and size < 12:
                    size += 1
                    mask = (1 << size) - 1
        out.append(entry)
        produced += len(entry)
        prev = entry
    return b"".join(out)[:count]


def _gif_rows(height: int) -> np.ndarray:
    """The row each stored row of an interlaced frame lands on: every 8th
    from 0, every 8th from 4, every 4th from 2, every 2nd from 1."""
    return np.concatenate([np.arange(start, height, step)
                           for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def decode_gif(blob: bytes, name: str = "image") -> np.ndarray:
    """The first frame of a GIF (87a or 89a) as (H, W, 3) uint8, as PIL's
    ``Image.open(...).convert("RGB")`` gives it.

    As PIL does: the logical screen grows to hold a frame that reaches past
    it; the frame's colour table is its local one, else the global one; a
    table that is the grey ramp ``(i, i, i)`` counts as none (a grey local
    table leaves the global one in force), and without a table an index
    ``i`` is the grey ``(i, i, i)``; an index past the table is black;
    outside a frame smaller
    than the screen lies the index that the graphic-control extension names
    transparent, else index 0 (not the background index); the transparent
    index shows its own colour. Bytes between blocks that start neither an
    extension nor an image are skipped, as PIL skips them.

    Raises ValueError on a truncated or corrupt file.
    """
    if blob[:6] not in (b"GIF87a", b"GIF89a") or len(blob) < 13:
        raise ValueError(f"{name} is not a GIF file")
    width, height, flags = struct.unpack_from("<HHB", blob, 6)
    pos = 13
    palette = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        if pos + size > len(blob):
            raise ValueError(f"{name}: truncated GIF in the global colour table")
        palette = _gif_palette(blob[pos : pos + size])
        pos += size
    transparency = None
    while True:
        if pos >= len(blob) or blob[pos] == 0x3B:
            raise ValueError(f"{name}: corrupt GIF: no image")
        tag = blob[pos]
        pos += 1
        if tag == 0x21:
            if pos >= len(blob):
                raise ValueError(f"{name}: truncated GIF in an extension")
            label = blob[pos]
            first = blob[pos + 2 : pos + 2 + blob[pos + 1]] if pos + 1 < len(blob) else b""
            if label == 0xF9 and first:
                if len(first) < 4:
                    raise ValueError(f"{name}: corrupt GIF: a short graphic-control block")
                if first[0] & 1:
                    transparency = first[3]
            _, pos = _gif_sub_blocks(blob, pos + 1, name)
        elif tag == 0x2C:
            break
    if pos + 9 > len(blob):
        raise ValueError(f"{name}: truncated GIF in an image descriptor")
    x0, y0, fw, fh, flags = struct.unpack_from("<HHHHB", blob, pos)
    pos += 9
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        if pos + size > len(blob):
            raise ValueError(f"{name}: truncated GIF in a local colour table")
        local = _gif_palette(blob[pos : pos + size])
        palette = palette if local is None else local
        pos += size
    if pos >= len(blob):
        raise ValueError(f"{name}: truncated GIF before the image data")
    min_size = blob[pos]
    if not 1 <= min_size <= 11:
        raise ValueError(f"{name}: corrupt GIF: LZW code size {min_size}")
    data, _ = _gif_sub_blocks(blob, pos + 1, name)
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    if fw and fh:
        frame = np.frombuffer(_gif_lzw(data, min_size, fw * fh, name), np.uint8)
        frame = frame.reshape(fh, fw)
        if flags & 0x40:
            frame = frame[np.argsort(_gif_rows(fh), kind="stable")]
        canvas[y0 : y0 + fh, x0 : x0 + fw] = frame
    if palette is None:
        return np.ascontiguousarray(np.repeat(canvas[..., None], 3, axis=-1))
    colours = np.zeros((256, 3), np.uint8)
    colours[: len(palette)] = palette[:256]
    return colours[canvas]


# ---------------------------------------------------------------------------
# Baseline JPEG encoding, as PIL's ``Image.save(path.jpg)`` of an RGB image
# ---------------------------------------------------------------------------

# jcparam.c's tables (natural order) and jstdhuff.c's Huffman tables:
# (code counts by length 1-16, symbols).
_STD_LUMINANCE_QUANT = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
_STD_CHROMINANCE_QUANT = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99)
_STD_HUFFMAN = {
    "dc_luminance": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
    "ac_luminance": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5"
        "f6f7f8f9fa")),
    "dc_chrominance": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12))),
    "ac_chrominance": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a1624"
        "34e125f11718191a262728292a35363738393a434445464748494a535455565758595a63646566"
        "6768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aa"
        "b2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
        "f5f6f7f8f9fa")),
}


def _quant_table(basic) -> np.ndarray:
    """``jcparam.c:jpeg_add_quant_table`` at PIL's default quality 75
    (``jpeg_quality_scaling``: 50%) with ``force_baseline``: each entry
    scaled, rounded, clamped to 1-255."""
    return np.clip((np.array(basic, np.int64) * 50 + 50) // 100, 1, 255)


def _huffman_codes(counts, symbols) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a table as (code, length) arrays by symbol."""
    code_of, length_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code = index = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[index]], length_of[symbols[index]] = code, length
            code += 1
            index += 1
        code <<= 1
    return code_of, length_of


def _edge_pad(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """``plane`` extended to (height, width) by repeating its last row and
    column (libjpeg's ``expand_bottom_edge`` / ``expand_right_edge``)."""
    return np.pad(plane, ((0, height - plane.shape[0]), (0, width - plane.shape[1])), "edge")


def _fdct_1d(d, out_shift):
    """One pass of ``jfdctint.c:jpeg_fdct_islow`` on eight int64 arrays; the
    even outputs 0 and 4 are shifted left by ``PASS1_BITS`` in the first
    pass (``out_shift`` None) and descaled by it in the second."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if out_shift is None:  # pass 1: CONST_BITS - PASS1_BITS, evens scaled up
        shift = 13 - 2
        out0, out4 = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    else:  # pass 2: CONST_BITS + PASS1_BITS, evens descaled by PASS1_BITS
        shift = 13 + 2
        out0, out4 = (tmp10 + tmp11 + 2) >> 2, (tmp10 - tmp11 + 2) >> 2
    half = 1 << (shift - 1)
    z1 = (tmp12 + tmp13) * 4433
    out2 = (z1 + tmp13 * 6270 + half) >> shift
    out6 = (z1 + tmp12 * -15137 + half) >> shift
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    return [out0, (tmp7 + z1 + z4 + half) >> shift, out2, (tmp6 + z2 + z3 + half) >> shift,
            out4, (tmp5 + z2 + z4 + half) >> shift, out6, (tmp4 + z1 + z3 + half) >> shift]


def _quantised_blocks(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """A plane whose sides are multiples of 8 as (rows, cols, 64) quantised
    coefficients in zigzag order: samples less 128, the islow forward DCT
    (rows, then columns; outputs 8x a true DCT's), then
    ``jcdctmgr.c``'s rounded division by 8x the table, toward zero."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    work = np.stack(_fdct_1d([blocks[..., k] for k in range(8)], None), axis=-1)
    coefs = np.stack(_fdct_1d([work[..., k, :] for k in range(8)], 2), axis=-2)
    divisor = quant.reshape(8, 8) * 8
    magnitude = (np.abs(coefs) + divisor // 2) // divisor
    quantised = np.where(coefs < 0, -magnitude, magnitude).reshape(rows, cols, 64)
    return quantised[..., _NATURAL[:64]]


def _value_bits(values: np.ndarray) -> typing.Tuple[np.ndarray, np.ndarray]:
    """JPEG's magnitude category of each value and its extra bits (a
    negative value as its ones' complement in that many bits)."""
    size = np.zeros(values.shape, np.int64)
    magnitude = np.abs(values)
    while np.any(magnitude >> size):
        size += (magnitude >> size) > 0
    return size, np.where(values < 0, values + (1 << size) - 1, values)


def _entropy_code(blocks: np.ndarray, chroma: np.ndarray, tables) -> bytes:
    """The Huffman-coded scan of (N, 64) zigzag blocks in stream order whose
    ``[:, 0]`` holds the DC differences; ``chroma`` says which blocks take
    the chrominance tables. Each block is its DC code, then per nonzero AC
    coefficient a ZRL per 16 zeros before it and its (run, size) code, then
    an EOB where the block ends in zeros. Returns the stuffed bytes, the
    last byte filled with ones."""
    count = len(blocks)
    block, index = np.nonzero(blocks[:, 1:])
    position = index + 1
    previous = np.zeros_like(position)
    follows = block[1:] == block[:-1]
    previous[1:][follows] = position[:-1][follows]
    run = position - previous - 1
    last = np.zeros(count, np.int64)
    last[block] = position  # the last write of a block is its last nonzero
    eob = np.nonzero(last < 63)[0]
    zeros = run >> 4
    zrl = np.repeat(block, zeros)
    dc_size, dc_bits = _value_bits(blocks[:, 0])
    ac_size, ac_bits = _value_bits(blocks[block, position])
    # (blocks, symbols, extra bits, their count, table pair, sort keys)
    events = [
        (np.arange(count), dc_size, dc_bits, dc_size, 0, np.arange(count) * 130),
        (block, ((run & 15) << 4) | ac_size, ac_bits, ac_size, 1, block * 130 + position * 2),
        (zrl, np.full(len(zrl), 0xF0), 0, 0, 1, zrl * 130 + np.repeat(position, zeros) * 2 - 1),
        (eob, np.zeros(len(eob), np.int64), 0, 0, 1, eob * 130 + 128),
    ]
    words, lengths, keys = [], [], []
    for which, symbol, extra, nextra, ac, key in events:
        luma, chrom = tables[ac], tables[ac + 2]
        table_chroma = chroma[which]
        code = np.where(table_chroma, chrom[0][symbol], luma[0][symbol])
        length = np.where(table_chroma, chrom[1][symbol], luma[1][symbol])
        words.append((code << nextra) | extra)
        lengths.append(length + nextra)
        keys.append(key)
    order = np.argsort(np.concatenate(keys), kind="stable")
    words = np.concatenate(words)[order]
    lengths = np.concatenate(lengths)[order]
    total = int(lengths.sum())
    event = np.repeat(np.arange(len(words)), lengths)
    offset = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    stream = ((words[event] >> (lengths[event] - 1 - offset)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])
    return np.packbits(stream).tobytes().replace(b"\xff", b"\xff\x00")


def _encode_jpeg(image: np.ndarray) -> bytes:
    """The bytes PIL writes for ``Image.fromarray(image).save(path.jpg)`` of
    an (H, W, 3) uint8 RGB image: baseline JPEG with a JFIF header, quality
    75, 4:2:0, the standard Huffman tables, by libjpeg's integer arithmetic
    (``jccolor.c``, ``jcsample.c:h2v2_downsample``, ``jfdctint.c``,
    ``jcdctmgr.c``; ``jccoefct.c``'s dummy blocks past the image). The
    ICDAR 2019 loader writes its converted GIFs with it."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"an (H, W, 3) uint8 image is needed, got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"a JPEG cannot hold a {width}x{height} image")
    r, g, b = (image[..., k].astype(np.int64) for k in range(3))
    # jccolor.c: SCALEBITS 16, Cb/Cr rounded with ONE_HALF - 1.
    half, offset = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + offset + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + offset + half - 1) >> 16
    mcus_x, mcus_y = _ceil_div(width, 16), _ceil_div(height, 16)
    blocks_x, blocks_y = _ceil_div(width, 8), _ceil_div(height, 8)
    luma_q = _quant_table(_STD_LUMINANCE_QUANT)
    chroma_q = _quant_table(_STD_CHROMINANCE_QUANT)
    luma = _quantised_blocks(_edge_pad(y, blocks_y * 8, blocks_x * 8), luma_q)
    # jccoefct.c: blocks of the MCU grid past the image's are zero with the
    # DC of the block to their left, below the image of the MCU's top right.
    grid = np.zeros((mcus_y * 2, mcus_x * 2, 64), np.int64)
    grid[:blocks_y, :blocks_x] = luma
    if blocks_x % 2:
        grid[:blocks_y, blocks_x, 0] = luma[:, -1, 0]
    if blocks_y % 2:
        grid[blocks_y, :, 0] = np.repeat(grid[blocks_y - 1, 1::2, 0], 2)
    planes = []
    for plane in (cb, cr):
        # jcsample.c:h2v2_downsample on rows and columns extended to whole
        # MCUs, the bias alternating 1, 2 along a row; then the rows to a
        # whole block row, repeating the last.
        full = _edge_pad(plane, 2 * _ceil_div(height, 2), mcus_x * 16)
        bias = np.tile([1, 2], mcus_x * 4)
        small = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
                 + bias) >> 2
        planes.append(_quantised_blocks(_edge_pad(small, mcus_y * 8, mcus_x * 8), chroma_q))
    luma_mcus = grid.reshape(mcus_y, 2, mcus_x, 2, 64).transpose(0, 2, 1, 3, 4)
    stream = np.concatenate([luma_mcus.reshape(mcus_y, mcus_x, 4, 64),
                             planes[0][:, :, None], planes[1][:, :, None]], axis=2)
    stream = stream.reshape(-1, 6, 64).copy()
    for slots in ((0, 1, 2, 3), (4,), (5,)):  # DC differences per component
        dc = stream[:, list(slots), 0].reshape(-1)
        stream[:, list(slots), 0] = np.diff(dc, prepend=0).reshape(-1, len(slots))
    chroma = np.tile([False] * 4 + [True] * 2, len(stream))
    tables = [_huffman_codes(*_STD_HUFFMAN[name]) for name in
              ("dc_luminance", "ac_luminance", "dc_chrominance", "ac_chrominance")]
    data = _entropy_code(stream.reshape(-1, 64), chroma, tables)

    def segment(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + bytes(body)

    zigzag = _NATURAL[:64]
    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for table_id, table in enumerate((luma_q, chroma_q)):
        out.append(segment(0xDB, bytes([table_id]) + bytes(table[zigzag].tolist())))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for table_class, table_id, name in ((0, 0, "dc_luminance"), (1, 0, "ac_luminance"),
                                        (0, 1, "dc_chrominance"), (1, 1, "ac_chrominance")):
        counts, symbols = _STD_HUFFMAN[name]
        out.append(segment(0xC4, bytes([table_class << 4 | table_id, *counts, *symbols])))
    out.append(segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


# Every format ``read`` takes, in the order of PIL's ``Image.ID`` once
# ``Image.init()`` has run: where two formats would take the same bytes,
# the first wins, as it does in ``Image.open``. IM has no magic bytes (PIL
# tries its opener on every file that reaches it) and TGA has none either.
_FORMATS = (
    ("AVIF", avif.is_avif, avif.decode_avif),
    ("BMP", lambda b: b[:2] == b"BM", decode_bmp),
    ("DIB", is_dib, decode_dib),
    ("CUR", lambda b: b[:4] == CUR_SIGNATURE and is_ico(b), decode_ico),
    ("PCX", is_pcx, decode_pcx),
    ("DCX", is_dcx, decode_dcx),
    ("GIF", lambda b: b[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("PNG", lambda b: b[:8] == _PNG_SIGNATURE, decode_png),
    ("JPEG 2000", is_jpeg2000, decode_jpeg2000),
    ("ICNS", rasters.is_icns, rasters.decode_icns),
    ("ICO", is_ico, decode_ico),
    ("IM", rasters.is_im, rasters.decode_im),
    ("JPEG", lambda b: b[:3] == _JPEG_SIGNATURE, decode_jpeg),
    ("TIFF", lambda b: b[:4] in TIFF_SIGNATURES, decode_tiff),
    ("MSP", rasters.is_msp, rasters.decode_msp),
    ("PNM (P1-P6)", lambda b: b[:2] in PNM_PREFIXES, decode_pnm),
    ("PSD", rasters.is_psd, rasters.decode_psd),
    ("QOI", rasters.is_qoi, rasters.decode_qoi),
    ("SGI", rasters.is_sgi, rasters.decode_sgi),
    ("Sun raster", rasters.is_sun, rasters.decode_sun),
    ("TGA", is_tga, decode_tga),
    ("WebP", lambda b: b[:4] == b"RIFF" and b[8:12] == b"WEBP", decode_webp),
    ("XBM", rasters.is_xbm, rasters.decode_xbm),
    ("XPM", rasters.is_xpm, rasters.decode_xpm),
)


def _decode(blob: bytes, name: str) -> np.ndarray:
    """A file's bytes as (H, W, 3) uint8 RGB, by the first format of
    ``_FORMATS`` (PIL's order) that takes them: AVIF, BMP, DIB, CUR, PCX, DCX,
    GIF, PNG, JPEG 2000, ICNS, ICO, IM, JPEG, TIFF, MSP, PNM, PSD, QOI,
    SGI, Sun raster, TGA, WebP, XBM or XPM. TGA and IM have no magic
    bytes: they take a file by the header checks PIL makes."""
    for _, accepts, decoder in _FORMATS:
        if accepts(blob):
            return decoder(blob, name)
    raise ValueError(f"{name} is none of the formats tools.read decodes: "
                     + ", ".join(kind for kind, _, _ in _FORMATS))


def read(filepath_or_buffer: typing.Union[str, typing.BinaryIO, np.ndarray]) -> np.ndarray:
    """An ndarray as is; a path, an ``http(s)://`` URL (fetched with
    :mod:`urllib.request`), or an object with ``.read``, whose bytes are
    decoded to RGB uint8 as PIL's ``Image.open(...).convert("RGB")`` gives
    them: PNG, JPEG (baseline, extended or progressive Huffman,
    arithmetic-coded sequential or progressive, lossless; sampling factors
    1-4; grey, RGB, CMYK or YCCK; :func:`decode_jpeg`), GIF (the first
    frame), TIFF (the first image; CCITT Group 3 and 4, LZW, Deflate,
    PackBits, JPEG or none), BMP and DIB, PNM (P1-P6), WebP (lossless,
    lossy, with alpha or metadata; the first frame of an animation;
    :mod:`.webp`), JPEG 2000 (JP2 / JPX files and raw codestreams;
    :mod:`.jpeg2000`), TGA, PCX, DCX (the first page), ICO and CUR
    (:mod:`.codecs`), PSD (the composite image), QOI, SGI, Sun raster,
    ICNS, IM, MSP, XBM and XPM (:mod:`.rasters`), AVIF (lossless AV1, the
    first frame of a sequence; :mod:`.avif`). The format is found as
    PIL finds it (``_FORMATS``). Other formats, and the kinds of these that
    PIL does not read either, raise ``ValueError`` or
    ``NotImplementedError``."""
    if isinstance(filepath_or_buffer, np.ndarray):
        return filepath_or_buffer
    if hasattr(filepath_or_buffer, "read"):
        return _decode(filepath_or_buffer.read(), "buffer")
    if isinstance(filepath_or_buffer, str):
        if _URL_RE.match(filepath_or_buffer):
            with urllib.request.urlopen(filepath_or_buffer) as response:
                return _decode(response.read(), repr(filepath_or_buffer))
        if not os.path.isfile(filepath_or_buffer):
            raise FileNotFoundError(f"Could not find image at path: {filepath_or_buffer}")
        with open(filepath_or_buffer, "rb") as f:
            return _decode(f.read(), repr(filepath_or_buffer))
    raise ValueError(f"Unsupported input type: {type(filepath_or_buffer)}")


def pad(image, width: int, height: int, cval: int = 255):
    """Bottom/right-pad an image up to (height, width) with ``cval``."""
    src_h, src_w = image.shape[:2]
    if src_h > height or src_w > width:
        raise ValueError(
            f"Cannot pad a ({src_h}, {src_w}) image to smaller ({height}, {width})."
        )
    canvas = np.full((height, width) + image.shape[2:], cval, dtype=image.dtype)
    canvas[:src_h, :src_w] = image
    return canvas


def read_and_fit(
    filepath_or_array: typing.Union[str, np.ndarray],
    width: int,
    height: int,
    cval: int = 255,
    mode="letterbox",
):
    """:func:`read` a path (an array passes as it is), then :func:`fit`."""
    image = read(filepath_or_array) if isinstance(filepath_or_array, str) else filepath_or_array
    return fit(image=image, width=width, height=height, cval=cval, mode=mode)


# ---------------------------------------------------------------------------
# Rotated boxes and their crops (the host warpBox)
# ---------------------------------------------------------------------------


def get_rotated_width_height(box):
    """(width, height) of a tl-tr-br-bl box: the means of its opposite
    sides' lengths, each truncated to an int."""
    box = np.asarray(box, dtype="float64")
    w = (np.linalg.norm(box[0] - box[1]) + np.linalg.norm(box[2] - box[3])) / 2
    h = (np.linalg.norm(box[0] - box[3]) + np.linalg.norm(box[1] - box[2])) / 2
    return int(w), int(h)


def get_rotated_box(points) -> typing.Tuple[np.ndarray, float]:
    """The min-area rectangle of ``points`` (the points as they are when
    fewer than 3 are distinct) as float32 tl-tr-br-bl corners, and its
    rotation ``arctan((tl_x - bl_x) / (tl_y - bl_y))``, 0 where that is
    NaN."""
    points = np.asarray(points, dtype="float64")
    pts = min_area_rect(points) if len(np.unique(points, axis=0)) >= 3 else points
    x_sorted = pts[np.argsort(pts[:, 0]), :]
    left_most = x_sorted[:2, :]
    right_most = x_sorted[2:, :]
    tl, bl = left_most[np.argsort(left_most[:, 1]), :]
    distances = np.linalg.norm(right_most - tl, axis=1)
    br, tr = right_most[np.argsort(distances)[::-1], :]
    pts = np.array([tl, tr, br, bl], dtype="float32")
    with np.errstate(divide="ignore", invalid="ignore"):
        rotation = np.arctan((tl[0] - bl[0]) / (tl[1] - bl[1]))
    if np.isnan(rotation):
        rotation = 0.0
    return pts, float(rotation)


def warpBox(
    image,
    box,
    target_height=None,
    target_width=None,
    margin=0,
    cval=None,
    return_transform=False,
    skip_rotate=False,
):
    """Perspective-crop the quadrilateral ``box`` of ``image`` into an
    axis-aligned rectangle, scaled to fit (target_height, target_width)
    with the aspect kept, top-left aligned on a ``cval`` canvas (uint8).
    Without targets the crop keeps the box's own size."""
    if cval is None:
        cval = (0, 0, 0) if len(image.shape) == 3 else 0
    box = np.asarray(box, dtype="float32")
    if not skip_rotate:
        box, _ = get_rotated_box(box)
    w, h = get_rotated_width_height(box)
    if (target_width is None) != (target_height is None):
        raise ValueError("Either both or neither of target width and height must be provided.")
    if target_width is None:
        target_width, target_height = w, h
    scale = min(target_width / w, target_height / h)
    M = get_perspective_transform(
        src=box,
        dst=np.array(
            [
                [margin, margin],
                [scale * w - margin, margin],
                [scale * w - margin, scale * h - margin],
                [margin, scale * h - margin],
            ],
            dtype="float32",
        ),
    )
    crop = warp_perspective(image, M, dsize=(int(scale * w), int(scale * h)))
    target_shape = (
        (target_height, target_width, 3) if len(image.shape) == 3 else (target_height, target_width)
    )
    full = (np.zeros(target_shape) + cval).astype("uint8")
    full[: crop.shape[0], : crop.shape[1]] = crop
    if return_transform:
        return full, M
    return full


# ---------------------------------------------------------------------------
# Lines of characters (the detector's training targets)
# ---------------------------------------------------------------------------


def flatten(list_of_lists):
    return [item for sublist in list_of_lists for item in sublist]


def combine_line(line):
    """One line of (box, character) entries -> one (box, text) word: the
    min-area rectangle of the boxes' top and bottom edges, rolled to start
    at the corner nearest the first box's top-left."""
    text = "".join([character if character is not None else "" for _, character in line])
    box = np.concatenate(
        [coords[:2] for coords, _ in line]
        + [np.array([coords[3], coords[2]]) for coords, _ in reversed(line)]
    ).astype("float32")
    first_point = box[0]
    box = min_area_rect(box)
    box = np.array(np.roll(box, -np.linalg.norm(box - first_point, axis=1).argmin(), 0))
    return box, text


def adjust_boxes(boxes, scale=1, boxes_format: str = "boxes"):
    """Scale boxes in one of the three reference formats: ``"boxes"`` (an
    array), ``"lines"`` (lists of (box, character)) or ``"predictions"``
    ((word, box) pairs)."""
    if scale == 1:
        return boxes
    if boxes_format == "boxes":
        return np.array(boxes) * scale
    if boxes_format == "lines":
        return [
            [(np.array(box) * scale, character) for box, character in line] for line in boxes
        ]
    if boxes_format == "predictions":
        return [(word, np.array(box) * scale) for word, box in boxes]
    raise NotImplementedError(f"Unsupported boxes format: {boxes_format}")


def augment(
    boxes,
    augmenter,
    image=None,
    boxes_format="boxes",
    image_shape=None,
    area_threshold=0.5,
    min_area=None,
):
    """Augment an image and its boxes together with one frozen draw of an
    :class:`keras_ocr_tpu_torch.data.augmentation.Augmenter`; returns the
    augmented image (None without ``image``) and the boxes that survive, in
    ``boxes_format`` (``"boxes"``, ``"lines"`` or ``"predictions"``),
    clipped to the augmented canvas. A box survives when its clipped area is
    at least ``area_threshold`` of its augmented area (both by the shoelace
    formula on int32-truncated corners) and, with ``min_area``, more than
    ``min_area``; a line whose every box is dropped disappears. Without an
    image, ``image_shape`` gives the canvas, whose new extent is where its
    bottom-right corner lands."""
    if image is None and image_shape is None:
        raise ValueError('One of "image" or "image_shape" must be provided.')
    augmenter = augmenter.to_deterministic()

    if image is not None:
        image_augmented = augmenter(image=image)
        image_shape = image.shape[:2]
        new_shape = image_augmented.shape[:2]
    else:
        image_augmented = None
        corner = augmenter.augment_keypoints(
            np.array([[image_shape[1], image_shape[0]]], dtype="float32"), image_shape
        )[0]
        new_shape = (corner[1], corner[0])

    def transform(box):
        """(keep, clipped) of one quad moved through the augmenter."""
        moved = augmenter.augment_keypoints(np.asarray(box, dtype="float32"), image_shape)
        full_area = polygon_area(moved.astype("int32"))
        if full_area == 0:
            return False, moved
        clipped = np.stack(
            [moved[:, 0].clip(0, new_shape[1]), moved[:, 1].clip(0, new_shape[0])], axis=1
        )
        visible_area = polygon_area(clipped.astype("int32"))
        keep = visible_area / full_area >= area_threshold and (
            min_area is None or visible_area > min_area
        )
        return keep, clipped

    if boxes_format == "boxes":
        survivors = [box for keep, box in map(transform, boxes) if keep]
    elif boxes_format == "lines":
        survivors = []
        for line in boxes:
            kept = [
                (box, character)
                for (keep, box), character in (
                    (transform(box), character) for box, character in line
                )
                if keep
            ]
            if kept:
                survivors.append(kept)
    elif boxes_format == "predictions":
        survivors = []
        for word, box in boxes:
            keep, clipped = transform(box)
            if keep:
                survivors.append((word, clipped))
    else:
        raise NotImplementedError(f"Unsupported boxes format: {boxes_format}")
    return image_augmented, survivors


def fix_line(line):
    """Order a line of (box, character) tuples left to right or top to
    bottom, each box as its rotated rectangle: returns the line and
    ``"horizontal"`` or ``"vertical"``, by the larger spread of the box
    centres."""
    oriented = [(get_rotated_box(box)[0], character) for box, character in line]
    centers = np.array([box.mean(axis=0) for box, _ in oriented])
    x_extent, y_extent = centers.max(axis=0) - centers.min(axis=0)
    if y_extent > x_extent:
        axis, orientation = 1, "vertical"
    else:
        axis, orientation = 0, "horizontal"
    return [oriented[i] for i in centers[:, axis].argsort()], orientation


# ---------------------------------------------------------------------------
# Drawing
# ---------------------------------------------------------------------------


def drawBoxes(image, boxes, color=(255, 0, 0), thickness=5, boxes_format="boxes"):
    """Draw boxes onto a copy of an image: each box's closed outline with
    Pillow's wide line and round joints (``ImageDraw.line(..., width=thickness,
    joint="curve")``, through :func:`keras_ocr_tpu_torch.data.raster.thick_polyline`).

    ``boxes_format`` is ``"boxes"`` (a list of (4, 2) boxes), ``"lines"``
    (lists of (box, character)) or ``"predictions"`` ((word, box) pairs).
    """
    from .data import raster

    if len(boxes) == 0:
        return image
    if boxes_format == "lines":
        boxes = [box for line in boxes for box, _ in line]
    if boxes_format == "predictions":
        boxes = [box for _, box in boxes]
    canvas = np.array(image, copy=True)
    for box in boxes:
        pts = np.asarray(box, dtype=np.float64).reshape(-1, 2)
        raster.thick_polyline(canvas, np.concatenate([pts, pts[:1]]), tuple(color),
                              thickness, joint="curve")
    return canvas


def drawAnnotations(image, predictions, ax=None):
    """Render predictions as a boxed image with labels in the margins:
    words whose boxes start in the left half of the image are labelled down
    the left margin (top to bottom in reading order), the rest down the
    right margin, each label arrowed to its box's first corner.
    ``matplotlib`` is imported here, on the call: without it the call raises
    ``ImportError``."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(drawBoxes(image=image, boxes=predictions, boxes_format="predictions"))
    ax.set_xticks([])
    ax.set_yticks([])

    img_height, img_width = image.shape[:2]
    in_reading_order = sorted(predictions, key=lambda p: p[1][:, 1].min())
    columns = {
        "left": [p for p in in_reading_order if p[1][:, 0].min() < img_width / 2],
        "right": [p for p in in_reading_order if p[1][:, 0].min() >= img_width / 2],
    }

    def place_label(side, slot, total, text, box):
        # Anchor the arrow at the box's first corner, in axes fractions
        # (matplotlib's y axis points up, the image's points down).
        anchor_x = box[0][0] / img_width
        anchor_y = 1 - box[0][1] / img_height
        ax.annotate(
            text=text,
            xy=(anchor_x, anchor_y),
            xytext=(-0.05 if side == "left" else 1.05, 1 - slot / total),
            xycoords="axes fraction",
            arrowprops={"arrowstyle": "->", "color": "r"},
            color="r",
            fontsize=14,
            horizontalalignment="right" if side == "left" else "left",
        )

    for side, group in columns.items():
        for slot, (text, box) in enumerate(group):
            place_label(side, slot, len(group), text, box)
    return ax


# ---------------------------------------------------------------------------
# Downloads and the cache
# ---------------------------------------------------------------------------


def sha256sum(filename) -> str:
    """The sha256 hex digest of a file."""
    return _filehash(filename, hashlib.sha256())


def md5sum(filename) -> str:
    """The md5 hex digest of a file, for files whose upstream publishes
    only md5 (keras-applications' EfficientNet checkpoints)."""
    return _filehash(filename, hashlib.md5())


def _filehash(filename, h) -> str:
    buffer = bytearray(128 * 1024)
    view = memoryview(buffer)
    with open(filename, "rb", buffering=0) as f:
        for n in iter(lambda: f.readinto(view), 0):
            h.update(view[:n])
    return h.hexdigest()


def get_default_cache_dir() -> str:
    """The weight and asset cache: ``KERAS_OCR_TPU_CACHE_DIR``, else
    ``KERAS_OCR_CACHE_DIR``, else ``~/.keras-ocr`` (keras-ocr's own, so
    that files it downloaded are reused)."""
    return os.environ.get(
        "KERAS_OCR_TPU_CACHE_DIR",
        os.environ.get("KERAS_OCR_CACHE_DIR", os.path.expanduser(os.path.join("~", ".keras-ocr"))),
    )


def download_and_verify(url, sha256=None, cache_dir=None, verbose=True, filename=None,
                        timeout=60) -> str:
    """The cached copy of ``url``, downloaded if it is missing or its sha256
    differs; raises ``ValueError`` if the result does not match ``sha256``.

    The transfer streams to ``<file>.partial``, renamed into place only on
    success, so an interrupted download never passes for a cached file;
    each socket read waits at most ``timeout`` seconds.
    """
    if cache_dir is None:
        cache_dir = get_default_cache_dir()
    if filename is None:
        filename = os.path.basename(urllib.parse.urlparse(url).path)
    filepath = os.path.join(cache_dir, filename)
    os.makedirs(os.path.split(filepath)[0], exist_ok=True)
    if verbose:
        print("Looking for " + filepath)
    if not os.path.isfile(filepath) or (sha256 and sha256sum(filepath) != sha256):
        if verbose:
            print("Downloading " + filepath)
        partial = filepath + ".partial"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as response:
                with open(partial, "wb") as f:
                    while True:
                        chunk = response.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
            os.replace(partial, filepath)
        finally:
            if os.path.isfile(partial):
                os.remove(partial)
    if sha256 is not None and sha256 != sha256sum(filepath):
        raise ValueError(f"sha256 mismatch for {filepath} (from {url})")
    return filepath


def safe_extract_zip(zip_path, destination):
    """Extract a zip archive, refusing (``ValueError``) any member that
    would land outside ``destination`` (absolute paths, ``..``); a
    truncated archive raises ``zipfile.BadZipFile``."""
    destination = os.path.realpath(destination)
    with zipfile.ZipFile(zip_path) as zfile:
        for member in zfile.namelist():
            target = os.path.realpath(os.path.join(destination, member))
            if target != destination and not target.startswith(destination + os.sep):
                raise ValueError(
                    f"refusing to extract {member!r} from {zip_path}: escapes {destination}"
                )
        zfile.extractall(destination)


def download_and_extract(url, destination, sha256=None, cache_dir=None, filename=None,
                         verbose=True) -> str:
    """:func:`download_and_verify`, then :func:`safe_extract_zip`; a cached
    archive that no longer opens as a zip is deleted and downloaded once
    more, and a second failure raises."""
    for attempt in range(2):
        zip_path = download_and_verify(url=url, sha256=sha256, cache_dir=cache_dir,
                                       filename=filename, verbose=verbose)
        try:
            safe_extract_zip(zip_path, destination)
            return zip_path
        except zipfile.BadZipFile:
            if attempt:
                raise
            warnings.warn(f"cached archive {zip_path} is corrupt; re-downloading")
            os.remove(zip_path)
