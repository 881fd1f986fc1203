"""Host image and geometry utilities of the port.

Counterparts of ``keras_ocr_tpu/tools.py`` (``read``, ``pad``,
``resize_image``, ``fit``, ``read_and_fit``, ``polygon_area``,
``convex_hull``, ``min_area_rect``, ``get_perspective_transform``,
``warp_perspective``, ``get_rotated_box``, ``warpBox``) with numpy and the
standard library only. PNG files are decoded by a small reader: colour
types 0, 2, 3, 4 and 6 at every bit depth the format allows, not
interlaced, to RGB uint8 as PIL's ``convert("RGB")`` gives them.
"""

from __future__ import annotations

import os
import struct
import typing
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# Samples per pixel of each PNG colour type: grey, RGB, palette index,
# grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


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
        if blob[:3] == _JPEG_SIGNATURE:
            raise NotImplementedError(f"{name}: JPEG decoding is not supported yet")
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


def read(filepath_or_buffer: typing.Union[str, typing.BinaryIO, np.ndarray]) -> np.ndarray:
    """An ndarray as is; a PNG path, or an object with ``.read`` that gives
    PNG bytes, decoded to RGB uint8."""
    if isinstance(filepath_or_buffer, np.ndarray):
        return filepath_or_buffer
    if hasattr(filepath_or_buffer, "read"):
        return decode_png(filepath_or_buffer.read(), "buffer")
    if isinstance(filepath_or_buffer, str):
        if not os.path.isfile(filepath_or_buffer):
            raise FileNotFoundError(f"Could not find image at path: {filepath_or_buffer}")
        with open(filepath_or_buffer, "rb") as f:
            return decode_png(f.read(), repr(filepath_or_buffer))
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
