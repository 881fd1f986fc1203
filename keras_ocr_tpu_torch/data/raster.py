"""Numpy rasterisers: glyph outlines to coverage, Pillow's text blend and
Pillow's wide lines.

``render_outline`` flattens a TrueType outline (quadratic B-splines with
implied on-curve points) into line segments and accumulates, for every
pixel cell a segment crosses, its signed cover and area, as FreeType's
smooth rasteriser does; the sweep along each row adds the covers to the
left, and the magnitude of the sum, clamped to one, is the nonzero-winding
coverage. Everything after the flattening is integer arithmetic in
1/4096 px, so two machines give the same bytes.

``draw_bitmap`` is Pillow's ``ImageDraw.text`` blend of a coverage mask
into an image, and ``thick_polyline`` is ``ImageDraw.line(xy, fill,
width, joint)``: Bresenham lines at width 1, else one filled quadrilateral
per segment and, for ``joint="curve"``, a pie slice at each inner vertex.
"""

from __future__ import annotations

import math
import typing

import numpy as np

_SUB_BITS = 12
_SUB = 1 << _SUB_BITS  # subpixel units per pixel
_TO_SUB = _SUB // 64  # from 26.6 to subpixel units
_FLATNESS = 1 / 32  # the farthest a flattened conic strays, in pixels


# ---------------------------------------------------------------------------
# Outlines
# ---------------------------------------------------------------------------


def flatten_outline(points, end_points, on_curve) -> typing.List[np.ndarray]:
    """The closed polygons (each (K, 2) int64, in 1/4096 px, last vertex
    not repeated) that ``render_outline`` fills for an outline given in
    26.6 fixed point."""
    points = np.asarray(points, dtype=np.int64) * _TO_SUB
    polygons = []
    begin = 0
    for end in end_points:
        polygon = _flatten_contour(points[begin : end + 1],
                                   np.asarray(on_curve[begin : end + 1], dtype=bool))
        begin = end + 1
        if len(polygon) >= 3:
            polygons.append(polygon)
    return polygons


def _flatten_contour(contour, flags):
    """One closed TrueType contour as a polygon: lines between on-curve
    points, conics flattened, an on-curve point implied midway between two
    off-curve ones."""
    n = len(contour)
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    on = np.flatnonzero(flags)
    if len(on):
        first = int(on[0])
        ring = [contour[(first + i) % n] for i in range(n)]
        ring_flags = [bool(flags[(first + i) % n]) for i in range(n)]
    else:
        ring = [(contour[-1] + contour[0]) // 2] + list(contour)
        ring_flags = [True] + [False] * n
    ring.append(ring[0])
    ring_flags.append(True)
    vertices = [ring[0]]
    current, control = ring[0], None
    for point, is_on in zip(ring[1:], ring_flags[1:]):
        if is_on:
            if control is None:
                vertices.append(point)
            else:
                vertices.extend(_flatten_conic(current, control, point)[1:])
                control = None
            current = point
        elif control is None:
            control = point
        else:
            middle = (control + point) // 2
            vertices.extend(_flatten_conic(current, control, middle)[1:])
            current, control = middle, point
    return np.array(vertices[:-1], dtype=np.int64).reshape(-1, 2)


def _conic_steps(p0, p1, p2) -> int:
    """Pieces for a conic so that the chord strays at most ``_FLATNESS``:
    a quadratic's chord error over a parameter step h is |p0-2p1+p2| h^2/4."""
    deviation = np.abs(p0 - 2 * p1 + p2).max() / _SUB
    return max(1, int(math.ceil(math.sqrt(deviation / (4 * _FLATNESS)))))


def _flatten_conic(p0, p1, p2) -> typing.List[np.ndarray]:
    steps = _conic_steps(p0, p1, p2)
    t = np.arange(steps + 1, dtype=np.float64)[:, None] / steps
    curve = (1 - t) ** 2 * p0 + 2 * t * (1 - t) * p1 + t * t * p2
    curve = np.round(curve).astype(np.int64)
    curve[0], curve[-1] = p0, p2
    return list(curve)


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------


def _round_div(num, den):
    """Elementwise num / den rounded half up, on int64."""
    negative = den < 0
    num = np.where(negative, -num, num)
    den = np.where(negative, -den, den)
    return (2 * num + den) // (2 * den)


def _grid_crossings(a0, a1, b0, b1):
    """Where segments cross the grid lines of their first coordinate that
    lie strictly between a0 and a1: (segment, a, b, t)."""
    low = np.minimum(a0, a1)
    high = np.maximum(a0, a1)
    first = low // _SUB + 1
    last = -((-high) // _SUB) - 1
    counts = np.maximum(last - first + 1, 0)
    segment = np.repeat(np.arange(len(a0)), counts)
    if not len(segment):
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, empty, np.zeros(0)
    starts = np.cumsum(counts) - counts
    step = np.arange(len(segment)) - np.repeat(starts, counts)
    a = (first[segment] + step) * _SUB
    da = a1[segment] - a0[segment]
    db = b1[segment] - b0[segment]
    b = b0[segment] + _round_div((a - a0[segment]) * db, da)
    t = (a - a0[segment]) / da
    return segment, a, b, t


def coverage_of_segments(segments, height: int, width: int) -> np.ndarray:
    """Nonzero-winding coverage (uint8, (height, width)) of closed paths
    given as (M, 4) int64 segments ``x0, y0, x1, y1`` in 1/4096 px, with
    the bitmap's top-left corner at the origin."""
    out = np.zeros((height, width), dtype=np.uint8)
    segments = np.asarray(segments, dtype=np.int64).reshape(-1, 4)
    segments = segments[segments[:, 1] != segments[:, 3]]
    if not len(segments) or not height or not width:
        return out
    x0, y0, x1, y1 = segments.T
    m = len(segments)
    # Every point where a segment enters a new cell, in order along it.
    sx, ax, bx, tx = _grid_crossings(x0, x1, y0, y1)  # vertical lines: (x, y)
    sy, ay, by, ty = _grid_crossings(y0, y1, x0, x1)  # horizontal lines: (y, x)
    index = np.arange(m)
    seg = np.concatenate([index, index, sx, sy])
    px = np.concatenate([x0, x1, ax, by])
    py = np.concatenate([y0, y1, bx, ay])
    t = np.concatenate([np.zeros(m), np.ones(m), tx, ty])
    order = np.lexsort((t, seg))
    seg, px, py = seg[order], px[order], py[order]
    same = seg[1:] == seg[:-1]
    xa, ya, xb, yb = px[:-1][same], py[:-1][same], px[1:][same], py[1:][same]
    dy = yb - ya
    keep = dy != 0
    xa, ya, xb, yb, dy = xa[keep], ya[keep], xb[keep], yb[keep], dy[keep]
    col = (xa + xb) // (2 * _SUB)
    row = (ya + yb) // (2 * _SUB)
    fx0 = xa - col * _SUB
    fx1 = xb - col * _SUB
    # Twice the signed area right of the piece inside its cell, and the
    # cover it hands every cell further right, in 1/4096^2 px^2.
    area = dy * (2 * _SUB - fx0 - fx1)
    cover = dy * (2 * _SUB)
    inside = (row >= 0) & (row < height) & (col < width)
    row, col, area, cover = row[inside], np.maximum(col[inside], 0), area[inside], cover[inside]
    flat = row * width + col
    areas = np.zeros(height * width, dtype=np.int64)
    covers = np.zeros(height * width, dtype=np.int64)
    np.add.at(areas, flat, area)
    np.add.at(covers, flat, cover)
    areas = areas.reshape(height, width)
    covers = covers.reshape(height, width)
    total = areas + np.cumsum(covers, axis=1) - covers
    full = 2 * _SUB * _SUB
    value = (np.abs(total) * 255 + full // 2) // full
    np.minimum(value, 255, out=value)
    out[:] = value
    return out


def render_outline(points, end_points, on_curve):
    """Coverage of an outline in 26.6 fixed point with the y axis down:
    (uint8 (H, W), (left, top)), the bitmap's top-left pixel. The bitmap
    spans the control box, floored and ceiled to whole pixels."""
    points = np.asarray(points, dtype=np.int64)
    if not len(points):
        return np.zeros((0, 0), dtype=np.uint8), (0, 0)
    left = int(points[:, 0].min()) >> 6
    top = int(points[:, 1].min()) >> 6
    right = (int(points[:, 0].max()) + 63) >> 6
    bottom = (int(points[:, 1].max()) + 63) >> 6
    polygons = flatten_outline(points, end_points, on_curve)
    origin = np.array([left, top], dtype=np.int64) * _SUB
    segments = [np.concatenate([p - origin, np.roll(p, -1, axis=0) - origin], axis=1)
                for p in polygons]
    segments = np.concatenate(segments) if segments else np.zeros((0, 4), dtype=np.int64)
    return coverage_of_segments(segments, bottom - top, right - left), (left, top)


# ---------------------------------------------------------------------------
# Pillow's text blend
# ---------------------------------------------------------------------------


def _div255(a):
    a = a + 128
    return ((a >> 8) + a) >> 8


def draw_bitmap(canvas: np.ndarray, mask: np.ndarray, ink, xy) -> np.ndarray:
    """Blend ``ink`` through the coverage ``mask`` into ``canvas`` in place
    with its top-left corner at the whole-pixel ``xy``, as Pillow's
    ``ImageDraw.text`` (``draw_bitmap``, then ``fill_mask_L``) does, clipped
    to the canvas. On an RGBA canvas a colour band takes the ink whole where
    the canvas is transparent and the mask is not zero."""
    x, y = int(xy[0]), int(xy[1])
    h, w = mask.shape
    height, width = canvas.shape[:2]
    r0, c0 = max(y, 0), max(x, 0)
    r1, c1 = min(y + h, height), min(x + w, width)
    if r1 <= r0 or c1 <= c0:
        return canvas
    m = mask[r0 - y : r1 - y, c0 - x : c1 - x].astype(np.int64)
    region = canvas[r0:r1, c0:c1]
    out = region.astype(np.int64)
    ink = np.asarray(ink, dtype=np.int64)
    if out.ndim == 2:
        region[:] = _div255(out * (255 - m) + ink.reshape(-1)[0] * m)
        return canvas
    bands = out.shape[2]
    if bands == 4:
        transparent = out[..., 3] == 0
        colour_mask = np.where((m != 0) & transparent, 255, m)
    else:
        colour_mask = m
    blended = np.empty_like(out)
    for band in range(bands):
        band_mask = m if (bands == 4 and band == 3) else colour_mask
        blended[..., band] = _div255(out[..., band] * (255 - band_mask) + ink[band] * band_mask)
    region[:] = blended
    return canvas


# ---------------------------------------------------------------------------
# Pillow's lines
# ---------------------------------------------------------------------------


def _ink(image, color):
    """The pixel value ``color`` writes into ``image`` (a 3-tuple on RGBA
    gets an opaque alpha)."""
    if image.ndim == 2:
        if isinstance(color, (tuple, list, np.ndarray)):
            if len(color) != 1:
                raise TypeError("a one-band image takes an integer colour")
            color = color[0]
        return np.uint8(color)
    bands = image.shape[2]
    color = tuple(int(c) for c in color)
    if bands == 4 and len(color) == 3:
        color = color + (255,)
    if len(color) < bands:
        raise ValueError(f"colour {color} has fewer bands than the image")
    return np.array(color[:bands], dtype=np.uint8)


def _round_up(f: float) -> int:
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


class _Writer:
    """Collects the pixels a drawing call sets, then writes them once."""

    def __init__(self, height, width):
        self.height, self.width = height, width
        self.mask = np.zeros((height, width), dtype=bool)

    def point(self, x, y):
        if 0 <= x < self.width and 0 <= y < self.height:
            self.mask[y, x] = True

    def hline(self, x0, y, x1):
        if not 0 <= y < self.height:
            return
        if x0 > x1:
            x0, x1 = x1, x0
        x0, x1 = max(x0, 0), min(x1, self.width - 1)
        if x0 <= x1:
            self.mask[y, x0 : x1 + 1] = True

    def line(self, x0, y0, x1, y1):
        """Pillow's ``line32``: Bresenham, the end point left out."""
        dx, xs = (x0 - x1, -1) if x1 < x0 else (x1 - x0, 1)
        dy, ys = (y0 - y1, -1) if y1 < y0 else (y1 - y0, 1)
        if dx == 0:
            for _ in range(dy):
                self.point(x0, y0)
                y0 += ys
        elif dy == 0:
            for _ in range(dx):
                self.point(x0, y0)
                x0 += xs
        elif dx > dy:
            n, dy2, e, dx2 = dx, 2 * dy, 2 * dy - dx, 2 * dx
            for _ in range(n):
                self.point(x0, y0)
                if e >= 0:
                    y0 += ys
                    e -= dx2
                e += dy2
                x0 += xs
        else:
            n, dx2, e, dy2 = dy, 2 * dx, 2 * dx - dy, 2 * dy
            for _ in range(n):
                self.point(x0, y0)
                if e >= 0:
                    x0 += xs
                    e -= dy2
                e += dx2
                y0 += ys

    def polygon(self, vertices):
        """Pillow's ``polygon_generic`` (nonzero fill off, hline spans)."""
        edges = []
        n = len(vertices)
        for i in range(n):
            (xa, ya), (xb, yb) = vertices[i], vertices[(i + 1) % n]
            edges.append(_Edge(xa, ya, xb, yb))
        ymin, ymax = self.height - 1, 0
        table = []
        for e in edges:
            ymin = min(ymin, e.ymin)
            ymax = max(ymax, e.ymax)
            if e.ymin == e.ymax:
                self.hline(e.xmin, e.ymin, e.xmax)
                continue
            table.append(e)
        ymin = max(ymin, 0)
        ymax = min(ymax, self.height)
        f32 = np.float32
        for y in range(ymin, ymax + 1):
            xx = []
            for i, current in enumerate(table):
                if not current.ymin <= y <= current.ymax:
                    continue
                xx.append(f32(f32(y - current.y0) * current.dx + f32(current.x0)))
                if y == current.ymax and y < ymax:
                    xx.append(xx[-1])
                elif current.dx != 0 and len(xx) % 2 == 1 and np.round(xx[-1]) == xx[-1]:
                    # Pillow's "connect discontiguous corners".
                    for k in range(i):
                        other = table[k]
                        if (current.dx > 0 and other.dx <= 0) or (current.dx < 0 and other.dx >= 0):
                            continue
                        at = f32(f32(y - other.y0) * other.dx + f32(other.x0))
                        if xx[-1] != at:
                            continue
                        offset = -1 if y == ymax else 1
                        here = f32(f32(y + offset - current.y0) * current.dx + f32(current.x0))
                        there = f32(f32(y + offset - other.y0) * other.dx + f32(other.x0))
                        if y == current.ymax:
                            value = max(here, there) + 1 if current.dx > 0 else min(here, there) - 1
                        else:
                            value = min(here, there) if current.dx > 0 else max(here, there) + 1
                        if k < len(xx):
                            xx[k] = f32(value)
                        break
            xx.sort()
            for i in range(1, len(xx), 2):
                start = _round_up(float(xx[i - 1]))
                end = _round_down(float(xx[i]))
                self.hline(start, y, end)

    def wide_line(self, x0, y0, x1, y1, width):
        """Pillow's ``ImagingDrawWideLine``: a quadrilateral about the
        segment, ``width`` pixels across."""
        dx, dy = x1 - x0, y1 - y0
        if dx == 0 and dy == 0:
            self.point(x0, y0)
            return
        big = math.hypot(dx, dy)
        small = (width - 1) / 2.0
        ratio_max = _round_up(small) / big
        ratio_min = _round_down(small) / big
        dxmin = _round_down(ratio_min * dy)
        dxmax = _round_down(ratio_max * dy)
        dymin = _round_down(ratio_min * dx)
        dymax = _round_down(ratio_max * dx)
        self.polygon([
            (x0 - dxmin, y0 + dymax),
            (x1 - dxmin, y1 + dymax),
            (x1 + dxmax, y1 - dymin),
            (x0 + dxmax, y0 - dymin),
        ])

    def pieslice(self, box, start, end):
        """Pillow's filled ``pieslice``: the box's corners truncated to
        whole pixels, the ellipse traced as Pillow's ``quarter_next`` traces
        it, and the pixels kept whose centres lie on the inner side of the
        start and end rays (Pillow's clip lines, taken at pixel centres)."""
        x0, y0, x1, y1 = (int(v) for v in box)
        a, b = x1 - x0, y1 - y0
        if a < 0 or b < 0 or (a == 0 and b == 0):
            return
        start, end = _normalize_angles(start, end)
        if start == end:
            return
        half_width = {}
        for x, y in _quarter(a, b):
            half_width[y] = max(half_width.get(y, -1), x)
        rows, cols = [], []
        for y, x in half_width.items():
            for yy in {y, -y}:
                span = np.arange(-x, x + 1, 2)
                rows.append(np.full(len(span), yy))
                cols.append(span)
        X = np.concatenate(cols).astype(np.float64)
        Y = np.concatenate(rows).astype(np.float64)
        if start + 360 != end:
            keep = _clip_inside(_clip_tree(a, b, start, end), X, Y)
            X, Y = X[keep], Y[keep]
        for px, py in zip(X.astype(np.int64), Y.astype(np.int64)):
            self.point(x0 + (int(px) + a) // 2, y0 + (int(py) + b) // 2)


def _quarter(a: int, b: int):
    """Pillow's ``quarter_next``: a quarter of the ellipse with axes a, b
    in doubled pixel coordinates, from (a, b % 2) to (a % 2, b), each step
    the neighbour nearest the curve."""
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        best = delta(nx, ny)
        if nx > 1:
            diagonal = delta(cx - 2, cy + 2)
            if best > diagonal:
                nx, ny, best = cx - 2, cy + 2, diagonal
            left = delta(cx - 2, cy)
            if best > left:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


def _normalize_angles(start, end):
    """Pillow's ``normalize_angles``: start in [0, 360), end after it."""
    if end - start >= 360:
        return 0.0, 360.0
    start = math.fmod(360 - math.fmod(-start, 360) if start < 0 else start, 360)
    end = start + math.fmod(360 - math.fmod(start - end, 360) if end < start
                            else end - start, 360)
    return start, end


def _clip_tree(a, b, start, end):
    """The half-planes ``A x + B y + C >= 0`` that bound a pie slice and how
    they combine, as Pillow's ``clip_ellipse_init`` builds them."""
    first, last = start * math.pi / 180, end * math.pi / 180
    left = ("clip", -a * math.sin(first), b * math.cos(first),
            (a * a - b * b) * math.sin(start * math.pi / 90) / 2)
    right = ("clip", a * math.sin(last), -b * math.cos(last),
             (b * b - a * a) * math.sin(end * math.pi / 90) / 2)
    join = "and" if end - start < 180 else "or"
    if math.fmod(start, 180) == 0 or math.fmod(end, 180) == 0:
        return (join, left, right)
    if (int(start / 180) + int(end / 180)) % 2 == 1:
        half = ("clip", 0.0, 1.0 if int(start / 180) % 2 == 0 else -1.0, 0.0)
        return ("and", ("or", half, right), left)
    half = ("clip", 0.0, 1.0 if (end < 180 or end > 540) else -1.0, 0.0)
    return (join, (join, left, right), half)


def _clip_inside(node, X, Y):
    if node[0] == "clip":
        _, A, B, C = node
        return A * X + B * Y + C >= -1e-9
    first, second = _clip_inside(node[1], X, Y), _clip_inside(node[2], X, Y)
    return first & second if node[0] == "and" else first | second


class _Edge:
    """Pillow's polygon edge (``add_edge``)."""

    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = np.float32(0.0) if y0 == y1 else np.float32(np.float32(x1 - x0) / np.float32(y1 - y0))
        self.x0, self.y0 = x0, y0


def _draw_lines(writer, points, width):
    """Pillow's ``draw_lines``: the points truncated to whole pixels."""
    ints = [(int(x), int(y)) for x, y in points]
    if width <= 1:
        for (xa, ya), (xb, yb) in zip(ints[:-1], ints[1:]):
            writer.line(xa, ya, xb, yb)
        if len(ints) > 1:
            writer.point(*ints[-1])
    else:
        for (xa, ya), (xb, yb) in zip(ints[:-1], ints[1:]):
            writer.wide_line(xa, ya, xb, yb, width)


def _line(writer, points, width, joint):
    """Pillow's ``ImageDraw.line`` on float points."""
    _draw_lines(writer, points, width)
    if joint != "curve" or width <= 4:
        return
    for i in range(1, len(points) - 1):
        point = points[i]
        angles = [
            math.degrees(math.atan2(end[0] - start[0], start[1] - end[1])) % 360
            for start, end in ((points[i - 1], point), (point, points[i + 1]))
        ]
        if angles[0] == angles[1]:
            continue

        def coord_at_angle(coord, angle):
            x, y = coord
            angle -= 90
            distance = width / 2 - 1
            return tuple(
                p + (math.floor(p_d) if p_d > 0 else math.ceil(p_d))
                for p, p_d in (
                    (x, distance * math.cos(math.radians(angle))),
                    (y, distance * math.sin(math.radians(angle))),
                )
            )

        flipped = (angles[1] > angles[0] and angles[1] - 180 > angles[0]) or (
            angles[1] < angles[0] and angles[1] + 180 > angles[0]
        )
        box = (point[0] - width / 2 + 1, point[1] - width / 2 + 1,
               point[0] + width / 2 - 1, point[1] + width / 2 - 1)
        if flipped:
            start, end = angles[1] + 90, angles[0] + 90
        else:
            start, end = angles[0] - 90, angles[1] - 90
        writer.pieslice(box, start - 90, end - 90)
        if width > 8:
            if flipped:
                gap = [coord_at_angle(point, angles[0] + 90), point,
                       coord_at_angle(point, angles[1] + 90)]
            else:
                gap = [coord_at_angle(point, angles[0] - 90), point,
                       coord_at_angle(point, angles[1] - 90)]
            _line(writer, gap, 3, None)


def thick_polyline(image: np.ndarray, points, color, width: int = 0,
                   joint: typing.Optional[str] = None) -> np.ndarray:
    """Draw the polyline through ``points`` into ``image`` in place, as
    Pillow's ``ImageDraw.Draw(image).line(points, fill=color, width=width,
    joint=joint)``: pixels are set to ``color``, not blended."""
    points = [(float(x), float(y)) for x, y in np.asarray(points, dtype=np.float64).reshape(-1, 2)]
    writer = _Writer(*image.shape[:2])
    _line(writer, points, width, joint)
    image[writer.mask] = _ink(image, color)
    return image
