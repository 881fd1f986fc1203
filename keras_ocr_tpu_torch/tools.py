"""Host image and geometry utilities of the port.

Counterparts of ``keras_ocr_tpu/tools.py`` (``read``, ``pad``,
``resize_image``, ``fit``, ``read_and_fit``, ``polygon_area``,
``convex_hull``, ``min_area_rect``, ``get_perspective_transform``,
``warp_perspective``, ``get_rotated_box``, ``warpBox``, and the line
helpers ``flatten``, ``combine_line``, ``adjust_boxes``, ``fix_line``) with numpy and the
standard library only. PNG files are decoded by a small reader: colour
types 0, 2, 3, 4 and 6 at every bit depth the format allows, not
interlaced, to RGB uint8 as PIL's ``convert("RGB")`` gives them. JPEG files
(sequential Huffman, 8-bit, grey or three components) are decoded by
:func:`decode_jpeg` with the arithmetic of PIL's libjpeg-turbo.
"""

from __future__ import annotations

import os
import re
import struct
import typing
import urllib.request
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# Samples per pixel of each PNG colour type: grey, RGB, palette index,
# grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_URL_RE = re.compile(r"^https?://", re.IGNORECASE)


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
    """Decode a non-interlaced PNG into (H, W, 3) uint8, as PIL's
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
    if interlace != 0:
        raise NotImplementedError(f"{name}: interlaced (Adam7) PNG is not supported yet")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    bits = width * channels * depth
    stride = (bits + 7) // 8
    rows = _unfilter(
        zlib.decompress(b"".join(idat)), height, stride, max(1, channels * depth // 8)
    )
    samples = _samples(rows, width, channels, depth)
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


def _zigzag():
    """The natural (row-major) index of each zigzag position, then 16
    entries of 63: a corrupt run past the block's end lands on the last
    coefficient, as in libjpeg's ``jpeg_natural_order``."""
    order = []
    for diagonal in range(15):
        rows = range(max(0, diagonal - 7), min(diagonal, 7) + 1)
        for row in rows if diagonal % 2 else reversed(rows):
            order.append(row * 8 + diagonal - row)
    return order + [63] * 16


_NATURAL = _zigzag()
# The frame types this decoder refuses, by SOF marker.
_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
}


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


def _windows(data: bytes) -> list:
    """For each byte offset, the 40 bits starting there (big-endian), with
    0xFF fill past the end: a 16-bit code and its extra bits are read from
    one window whatever the bit offset in the first byte."""
    raw = np.frombuffer(data + b"\xff" * 8, np.uint8).astype(np.int64)
    n = len(data) + 1
    win = raw[:n] << 32
    for i in range(1, 5):
        win |= raw[i : n + i] << (32 - 8 * i)
    return win.tolist()


def _decode_interval(data, blocks, name):
    """Entropy-decode the blocks of one restart interval from its unstuffed
    bytes. ``blocks`` holds (coefficients, base, DC table, AC table,
    predictor slot, predictors) per block in stream order; coefficients
    land in natural order at ``base``."""
    win = _windows(data)
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


def _upsample(plane, rh, rv, width, height):
    """A component plane of (ceil(height / rv), ceil(width / rh)) real
    samples to (height, width), as libjpeg-turbo's ``jdsample.c`` with fancy
    upsampling: h2v1 and h2v2 triangle filters (h2v2 with its alternating
    +8/+7 bias) on planes wider than 2 samples, box replication otherwise,
    and the h1v2 filter; neighbours past an edge repeat the edge."""
    x = plane.astype(np.int32)
    if rv == 2:
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        if rh == 1:
            out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
            out[0::2] = (3 * x + above + 1) >> 2
            out[1::2] = (3 * x + below + 2) >> 2
            return out[:height, :width].astype(np.uint8)
        if x.shape[1] > 2:
            sums = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
            sums[0::2] = 3 * x + above
            sums[1::2] = 3 * x + below
            left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
            right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
            out = np.empty((sums.shape[0], 2 * sums.shape[1]), np.int32)
            out[:, 0::2] = (3 * sums + left + 8) >> 4
            out[:, 1::2] = (3 * sums + right + 7) >> 4
            return out[:height, :width].astype(np.uint8)
        return np.repeat(np.repeat(plane, 2, 0), 2, 1)[:height, :width]
    if rh == 2:
        if x.shape[1] > 2:
            left = np.concatenate([x[:, :1], x[:, :-1]], 1)
            right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
            out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
            out[:, 0::2] = (3 * x + left + 1) >> 2
            out[:, 1::2] = (3 * x + right + 2) >> 2
            return out[:height, :width].astype(np.uint8)
        return np.repeat(plane, 2, 1)[:height, :width]
    return plane[:height, :width]


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
    """Decode a sequential Huffman-coded JPEG (SOF0 baseline or SOF1
    extended, 8-bit) of 1 or 3 components, sampling factors 1-2 on each
    axis, into (H, W, 3) uint8 as PIL's ``Image.open(...).convert("RGB")``
    gives it: libjpeg-turbo's islow IDCT, fancy upsampling and YCbCr
    tables; grey repeated over three channels; no colour conversion for an
    Adobe transform 0 or component ids R, G, B (a JFIF marker means
    YCbCr). The EXIF orientation is not applied, as PIL's ``open`` does not.

    Raises NotImplementedError naming the kind of a progressive, lossless,
    hierarchical, arithmetic-coded, 12-bit or 4-component JPEG, and
    ValueError on a truncated or corrupt stream.
    """
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{name} is not a JPEG file")
    quant, tables = {}, {}
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
            raise NotImplementedError(f"{name}: arithmetic-coded JPEG (DAC) is not supported")
        if marker == 0xE0 and segment[:5] == b"JFIF\x00":
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
        elif marker in (0xC0, 0xC1):
            frame = _read_frame(segment, name)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: corrupt JPEG: a scan before the frame header")
            end = _scan_data_end(blob, pos)
            _decode_scan(frame, segment, blob[pos:end], quant, tables, restart, name)
            scans += 1
            pos = end
    if frame is None or not scans:
        raise ValueError(f"{name}: corrupt JPEG: no frame or no scan")
    return _assemble(frame, jfif, adobe_transform, name)


def _read_frame(segment, name):
    """The SOF0/SOF1 header: image size and, per component, its id,
    sampling factors and block grid (padded to whole MCUs)."""
    if len(segment) < 6:
        raise ValueError(f"{name}: corrupt JPEG: bad SOF segment")
    precision, height, width, count = struct.unpack(">BHHB", segment[:6])
    if precision != 8:
        raise NotImplementedError(f"{name}: {precision}-bit JPEG is not supported")
    if count == 4:
        raise NotImplementedError(f"{name}: 4-component (CMYK or YCCK) JPEG is not supported")
    if count not in (1, 3) or len(segment) < 6 + 3 * count:
        raise NotImplementedError(f"{name}: {count}-component JPEG is not supported")
    if height == 0 or width == 0:
        raise NotImplementedError(f"{name}: JPEG with a DNL-defined or zero size")
    components = []
    for i in range(count):
        ident, sampling, table = segment[6 + 3 * i : 9 + 3 * i]
        components.append({"id": ident, "h": sampling >> 4, "v": sampling & 15, "quant": table})
    hmax = max(c["h"] for c in components)
    vmax = max(c["v"] for c in components)
    for c in components:
        if not (1 <= c["h"] <= 2 and 1 <= c["v"] <= 2) or hmax % c["h"] or vmax % c["v"]:
            raise NotImplementedError(
                f"{name}: JPEG sampling factors {[(c['h'], c['v']) for c in components]}"
            )
    mcus_x = _ceil_div(width, 8 * hmax)
    mcus_y = _ceil_div(height, 8 * vmax)
    for c in components:
        c["blocks"] = (mcus_y * c["v"], mcus_x * c["h"])
        c["coefs"] = [0] * (mcus_y * c["v"] * mcus_x * c["h"] * 64)
        c["q"] = None
    return {"width": width, "height": height, "hmax": hmax, "vmax": vmax,
            "mcus": (mcus_y, mcus_x), "components": components}


def _decode_scan(frame, header, data, quant, tables, restart, name):
    """Decode one sequential scan: its components interleaved in MCUs, or
    one component in its own block grid."""
    count = header[0] if header else 0
    if not 1 <= count <= len(frame["components"]) or len(header) < 1 + 2 * count + 3:
        raise ValueError(f"{name}: corrupt JPEG: bad SOS segment")
    by_id = {c["id"]: c for c in frame["components"]}
    members = []
    preds = [0] * count
    for slot in range(count):
        ident, selectors = header[1 + 2 * slot : 3 + 2 * slot]
        component = by_id.get(ident)
        dc, ac = tables.get((0, selectors >> 4)), tables.get((1, selectors & 15))
        if component is None or dc is None or ac is None:
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
    per_interval = restart or len(order)
    pieces = re.split(rb"\xff[\xd0-\xd7]", data) if restart else [data]
    intervals = _ceil_div(len(order), per_interval)
    if len(pieces) < intervals:
        raise ValueError(f"{name}: truncated JPEG: {len(pieces)} of {intervals} restart intervals")
    for i in range(intervals):
        preds[:] = [0] * count
        blocks = [b for mcu in order[i * per_interval : (i + 1) * per_interval] for b in mcu]
        _decode_interval(pieces[i].replace(b"\xff\x00", b"\xff"), blocks, name)


def _assemble(frame, jfif, adobe_transform, name):
    """Dequantise, IDCT, upsample and convert the decoded coefficients."""
    width, height = frame["width"], frame["height"]
    planes = []
    for c in frame["components"]:
        if c["q"] is None:
            raise ValueError(f"{name}: corrupt JPEG: component {c['id']} is in no scan")
        rows, cols = c["blocks"]
        coefs = np.array(c["coefs"], np.int64).reshape(rows * cols, 8, 8) * c["q"]
        samples = _idct_blocks(coefs).reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
        samples = samples.reshape(rows * 8, cols * 8)
        rh, rv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        real = samples[: _ceil_div(height, rv), : _ceil_div(width, rh)]
        planes.append(_upsample(real, rh, rv, width, height))
    if len(planes) == 1:
        return np.ascontiguousarray(np.repeat(planes[0][..., None], 3, axis=-1))
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


def _decode(blob: bytes, name: str) -> np.ndarray:
    """A PNG or JPEG file's bytes as (H, W, 3) uint8 RGB."""
    if blob[:8] == _PNG_SIGNATURE:
        return decode_png(blob, name)
    if blob[:3] == _JPEG_SIGNATURE:
        return decode_jpeg(blob, name)
    raise ValueError(f"{name} is neither a PNG nor a JPEG file")


def read(filepath_or_buffer: typing.Union[str, typing.BinaryIO, np.ndarray]) -> np.ndarray:
    """An ndarray as is; a path, an ``http(s)://`` URL (fetched with
    :mod:`urllib.request`), or an object with ``.read``, whose PNG or JPEG
    bytes are decoded to RGB uint8."""
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
