"""Batched perspective word-crop extraction on the device.

Port of ``keras_ocr_tpu/ops/warp.py``. Each box is ordered tl-tr-br-bl, its
target size is the int-truncated mean edge lengths, and the inverse map
is the closed-form unit-square-to-quad homography composed with a diagonal
rescale. Sampling goes through a static ``(window_height, window_width)``
source window at the box's 1-px-padded AABB: an exact slice when the AABB
fits, an antialiased (bilinear) downscale of the AABB otherwise; the crop
then samples the window bilinearly, taps outside the window reading zero.
Only the top-left ``int(scale*h) x int(scale*w)`` region of the canvas is
the crop; the rest is 0 (the ``cval`` of the JAX pipeline).

The JAX package expresses both resampling stages as one-hot matrix
products (XLA:TPU serialises gathers). Each output pixel has only 2x2
nonzero taps per stage, so here they are gathers with the same hat
weights, multiplied and summed in float32 in the order of those products:
no matrix product, no TF32.
"""

from __future__ import annotations

import torch

# Source-window escalation ladder (keras_ocr_tpu/ops/warp.py:WINDOW_LADDER).
WINDOW_LADDER = ((64, 512), (128, 1024), (256, 2048))


def _norm(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _take(points, index):
    """points (..., 4, 2), index (..., k) -> (..., k, 2)."""
    return torch.gather(points, -2, index[..., None].expand(*index.shape, 2))


def order_corners(box):
    """Order (..., 4, 2) points tl-tr-br-bl (imutils scheme)."""
    order = torch.argsort(box[..., 0], dim=-1, stable=True)
    left = _take(box, order[..., :2])
    right = _take(box, order[..., 2:])
    left_order = torch.argsort(left[..., 1], dim=-1, stable=True)
    tl = _take(left, left_order[..., :1])[..., 0, :]
    bl = _take(left, left_order[..., 1:])[..., 0, :]
    far = torch.argmax(_norm(right - tl[..., None, :]), dim=-1, keepdim=True)
    br = _take(right, far)[..., 0, :]
    tr = _take(right, 1 - far)[..., 0, :]
    return torch.stack([tl, tr, br, bl], dim=-2)


def square_to_quad(quad):
    """Closed-form homography (..., 3, 3) mapping the unit square onto
    (..., 4, 2) quads (Heckbert's projective mapping)."""
    x0, x1, x2, x3 = quad[..., 0, 0], quad[..., 1, 0], quad[..., 2, 0], quad[..., 3, 0]
    y0, y1, y2, y3 = quad[..., 0, 1], quad[..., 1, 1], quad[..., 2, 1], quad[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    g = (sx * dy2 - sy * dx2) / den
    h = (dx1 * sy - dy1 * sx) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    one = torch.ones_like(g)
    return torch.stack(
        [torch.stack([a, b, x0], -1), torch.stack([d, e, y0], -1), torch.stack([g, h, one], -1)],
        -2,
    )


def perspective_transform(src, dst):
    """3x3 homography mapping ``src`` (4, 2) onto ``dst`` (4, 2), from the
    8x8 linear system ``torch.linalg.solve`` solves in float32 (as the JAX
    function's ``jnp.linalg.solve``)."""
    src, dst = src.to(torch.float32), dst.to(torch.float32)
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=1)
    h = torch.linalg.solve(torch.cat([rows_u, rows_v]), torch.cat([u, v]))
    return torch.cat([h, torch.ones_like(h[:1])]).reshape(3, 3)


def _hat(delta):
    """Bilinear interpolation weight: max(0, 1 - |delta|)."""
    return torch.clamp(1.0 - torch.abs(delta), min=0.0)


def _taps(pos, size):
    """The two integer taps around ``pos`` and their hat weights; a tap
    outside [0, size) gets weight 0 (and a clamped, harmless index)."""
    lo = torch.floor(pos)
    out = []
    for tap in (lo, lo + 1.0):
        weight = torch.where((tap >= 0) & (tap <= size - 1), _hat(pos - tap), 0.0)
        out.append((tap.clamp(0, size - 1).to(torch.int64), weight))
    return out


def warp_boxes(
    image,
    boxes,
    target_height: int = 31,
    target_width: int = 200,
    cval: float = 0.0,
    window_height: int = 64,
    window_width: int = 512,
):
    """Crop every box of one (H, W) or (H, W, C) image into a
    (target_height, target_width) canvas: (N, 4, 2) boxes -> (N, th,
    tw[, C]) float32 crops, the canvas outside each crop ``cval``. The
    single-image form of :func:`warp_boxes_batch`."""
    return _warp(image[None], boxes[None], target_height, target_width, window_height,
                 window_width, cval)[0]


def warp_boxes_batch(
    images,
    boxes,
    target_height: int = 31,
    target_width: int = 200,
    window_height: int = 64,
    window_width: int = 512,
    word_chunk: int = 8,
):
    """(B, H, W[, C]) images x (B, N, 4, 2) boxes -> (B, N, th, tw[, C])
    float32 crops. ``word_chunk`` (the JAX function's bound on the words it
    resamples at once, which its one-hot matrices need) is accepted and
    ignored: the 2x2-tap gathers here need no such bound."""
    del word_chunk
    return _warp(images, boxes, target_height, target_width, window_height, window_width, 0.0)


def _warp(images, boxes, target_height, target_width, window_height, window_width, cval):
    """:func:`warp_boxes_batch` with ``cval`` outside the crops."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    images = images.to(torch.float32)
    batch, height, width, channels = images.shape
    num = boxes.shape[1]
    # Out-of-image taps must read 0: pad so every window lies in range.
    pad_h = max(window_height, height) - height
    pad_w = max(window_width, width) - width
    if pad_h or pad_w:
        images = torch.nn.functional.pad(images, (0, 0, 0, pad_w, 0, pad_h))
    padded_h, padded_w = images.shape[1:3]
    device = images.device

    box = order_corners(boxes.to(torch.float32))  # (B, N, 4, 2)
    def edge(i, j):
        return _norm(box[..., i, :] - box[..., j, :])

    w = torch.floor((edge(0, 1) + edge(2, 3)) / 2)
    h = torch.floor((edge(0, 3) + edge(1, 2)) / 2)
    w = torch.clamp(w, min=1.0)
    h = torch.clamp(h, min=1.0)
    # tensor / tensor: PyTorch evaluates `scalar / tensor` as a reciprocal
    # times the scalar, which is not the correctly rounded quotient.
    scale = torch.minimum(
        torch.full_like(w, target_width) / w, torch.full_like(h, target_height) / h
    )
    sw = (scale * w)[..., None, None]
    sh = (scale * h)[..., None, None]
    m = square_to_quad(box)[:, :, None, None]  # (B, N, 1, 1, 3, 3)
    gy, gx = torch.meshgrid(
        torch.arange(target_height, dtype=torch.float32, device=device),
        torch.arange(target_width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    gu = gx / sw
    gv = gy / sh
    denom = m[..., 2, 0] * gu + m[..., 2, 1] * gv + m[..., 2, 2]
    sx = (m[..., 0, 0] * gu + m[..., 0, 1] * gv + m[..., 0, 2]) / denom
    sy = (m[..., 1, 0] * gu + m[..., 1, 1] * gv + m[..., 1, 2]) / denom

    # Source window: 1px-padded AABB of the ordered quad.
    bx, by = box[..., 0], box[..., 1]
    x_start = torch.clamp(torch.floor(bx.amin(-1)) - 1.0, 0.0, float(padded_w - window_width))
    y_start = torch.clamp(torch.floor(by.amin(-1)) - 1.0, 0.0, float(padded_h - window_height))
    src_w = torch.ceil(bx.amax(-1)) - torch.floor(bx.amin(-1)) + 3.0
    src_h = torch.ceil(by.amax(-1)) - torch.floor(by.amin(-1)) + 3.0
    one = torch.ones_like(src_w)
    rate_x = torch.where(src_w <= window_width, one, (one * (window_width - 1.0)) / src_w)
    rate_y = torch.where(src_h <= window_height, one, (one * (window_height - 1.0)) / src_h)
    x_start, y_start = x_start[..., None, None], y_start[..., None, None]
    rate_x, rate_y = rate_x[..., None, None], rate_y[..., None, None]

    flat = images.reshape(batch, padded_h * padded_w, channels)

    def pixels(row, col):
        """image[b, row, col] for (B, N, th, tw) int64 indices."""
        index = (row * padded_w + col).reshape(batch, -1, 1).expand(-1, -1, channels)
        return torch.gather(flat, 1, index).reshape(*row.shape, channels)

    def window(r, c):
        """The (downscaled) window at integer window coords (r, c): rows
        first, then columns, like the JAX strip/window products."""
        (h0, wh0), (h1, wh1) = _taps(y_start + r / rate_y, padded_h)
        (c0, wc0), (c1, wc1) = _taps(x_start + c / rate_x, padded_w)
        left = wh0[..., None] * pixels(h0, c0) + wh1[..., None] * pixels(h1, c0)
        right = wh0[..., None] * pixels(h0, c1) + wh1[..., None] * pixels(h1, c1)
        return wc0[..., None] * left + wc1[..., None] * right

    (r0, wr0), (r1, wr1) = _taps((sy - y_start) * rate_y, window_height)
    (q0, wq0), (q1, wq1) = _taps((sx - x_start) * rate_x, window_width)
    r0, r1, q0, q1 = (t.to(torch.float32) for t in (r0, r1, q0, q1))
    top = wq0[..., None] * window(r0, q0) + wq1[..., None] * window(r0, q1)
    bottom = wq0[..., None] * window(r1, q0) + wq1[..., None] * window(r1, q1)
    out = wr0[..., None] * top + wr1[..., None] * bottom

    valid = (gx < torch.floor(sw)) & (gy < torch.floor(sh))
    crops = torch.where(valid[..., None], out, torch.full_like(out, cval))
    if squeeze:
        crops = crops[..., 0]
    return crops.reshape((batch, num) + crops.shape[2:])


def window_overflow(boxes, mask, window_height: int, window_width: int):
    """(B, N, 4, 2) boxes + validity -> (B,) bool: any valid quad's padded
    AABB exceeds the source window (same +3 px padding as the warp)."""
    bx = boxes[..., 0]
    by = boxes[..., 1]
    src_w = torch.ceil(bx.amax(-1)) - torch.floor(bx.amin(-1)) + 3.0
    src_h = torch.ceil(by.amax(-1)) - torch.floor(by.amin(-1)) + 3.0
    over = (src_w > window_width) | (src_h > window_height)
    return (over & mask).any(-1)
