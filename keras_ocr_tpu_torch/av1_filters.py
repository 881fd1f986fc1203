"""AV1's loop filters after reconstruction, for :mod:`.av1`: deblocking
(section 7.14) and CDEF (section 7.15), at bit depth 8, on int32 planes of
the decoded area (MiRows x MiCols 4x4s).

Deblocking runs plane by plane, the vertical edges of the whole plane and
then the horizontal ones. The edges of one column (or row) of 4x4s are
filtered at once, over every line that crosses them, as numpy vectors;
the columns go from left to right (rows top to bottom), since a filter
reads what the one before it wrote. CDEF filters every 8x8 block of the
deblocked frame at once, reading only the deblocked frame.
"""

from __future__ import annotations

import numpy as np

from . import av1_tables as T


def _levels(frame) -> list:
    """The filter level of each segment for each of Y vertical, Y
    horizontal, U and V (7.14.4 for an intra block): the frame's level,
    the segment's loop-filter feature, and the intra reference delta
    scaled by the level's top bit."""
    out = []
    for segment in range(8):
        row = []
        for i in range(4):
            level = frame.lf_levels[i]
            if frame.feature_enabled[segment][1 + i]:
                level = min(63, max(0, level + frame.feature_data[segment][1 + i]))
            if frame.lf_delta_enabled:
                level = min(63, max(0, level + (frame.lf_ref_delta << (level >> 5))))
            row.append(level)
        out.append(row)
    return out


def _narrow(p1, p0, q0, q1, hev):
    """The 4-tap filter (7.14.6.3): new p1, p0, q0, q1."""
    def clamp(v):
        return np.clip(v, -128, 127)

    ps1, ps0, qs0, qs1 = p1 - 128, p0 - 128, q0 - 128, q1 - 128
    base = np.where(hev, clamp(ps1 - qs1), 0)
    base = clamp(base + 3 * (qs0 - ps0))
    filter1 = clamp(base + 4) >> 3
    filter2 = clamp(base + 3) >> 3
    new_q0 = clamp(qs0 - filter1) + 128
    new_p0 = clamp(ps0 + filter2) + 128
    outer = (filter1 + 1) >> 1
    new_q1 = np.where(hev, q1, clamp(qs1 - outer) + 128)
    new_p1 = np.where(hev, p1, clamp(ps1 + outer) + 128)
    return new_p1, new_p0, new_q0, new_q1


def _wide(f, n: int, log2: int, inner: int):
    """The wide filters (7.14.6.4): ``f`` holds p6..q6 as f[:, 0..13]
    (p0 at 6, q0 at 7); returns the new values at offsets -n..n-1 from
    q0, as columns 7 - n .. 6 + n."""
    out = []
    for i in range(-n, n):
        total = 0
        for j in range(-n, n + 1):
            k = min(n, max(-(n + 1), i + j))
            total = total + f[:, 7 + k] * (2 if abs(j) <= inner else 1)
        out.append((total + (1 << (log2 - 1))) >> log2)
    return out


def _filter_edge(f, size, level, sharpness: int, chroma: bool, seen: set):
    """Filters one edge across all its lines: ``f`` (lines x 14) holds
    p6..q6 of each line, ``size`` the filter size (4, 8 or 16; 0 where
    nothing is filtered) and ``level`` the filter level of each line.
    Returns the new p5..q5 (lines x 12); ``seen`` gains the lengths of the
    filters applied."""
    shift = 2 if sharpness > 4 else 1 if sharpness > 0 else 0
    limit = level >> shift
    limit = np.clip(limit, 1, 9 - sharpness) if sharpness > 0 else np.maximum(1, limit)
    blimit = 2 * (level + 2) + limit
    thresh = level >> 4
    p = [f[:, 6 - k] for k in range(7)]
    q = [f[:, 7 + k] for k in range(7)]
    ad = np.abs
    hev = (ad(p[1] - p[0]) > thresh) | (ad(q[1] - q[0]) > thresh)
    mask = ((ad(p[1] - p[0]) <= limit) & (ad(q[1] - q[0]) <= limit)
            & (ad(p[0] - q[0]) * 2 + (ad(p[1] - q[1]) >> 1) <= blimit))
    mask6 = mask & (ad(p[2] - p[1]) <= limit) & (ad(q[2] - q[1]) <= limit)
    mask8 = mask6 & (ad(p[3] - p[2]) <= limit) & (ad(q[3] - q[2]) <= limit)
    flat = ((ad(p[1] - p[0]) <= 1) & (ad(q[1] - q[0]) <= 1) & (ad(p[2] - p[0]) <= 1)
            & (ad(q[2] - q[0]) <= 1))
    if chroma:
        mask = np.where(size >= 8, mask6, mask)
    else:
        mask = np.where(size >= 8, mask8, mask)
        flat = flat & (ad(p[3] - p[0]) <= 1) & (ad(q[3] - q[0]) <= 1)
    flat2 = ((ad(p[6] - p[0]) <= 1) & (ad(q[6] - q[0]) <= 1) & (ad(p[5] - p[0]) <= 1)
             & (ad(q[5] - q[0]) <= 1) & (ad(p[4] - p[0]) <= 1) & (ad(q[4] - q[0]) <= 1))
    mask &= size > 0
    narrow = mask & ((size == 4) | ~flat)
    wide8 = mask & (size >= 8) & flat & ((size == 8) | ~flat2)
    wide16 = mask & (size == 16) & flat & flat2
    plane = "chroma" if chroma else "luma"
    for taps, used in ((4, narrow), (6 if chroma else 8, wide8), (14, wide16)):
        if used.any():
            seen.add(f"deblock {plane} {taps}")
    out = f[:, 1:13].copy()
    new = _narrow(p[1], p[0], q[0], q[1], hev)
    for k, col in zip((4, 5, 6, 7), new):
        out[:, k] = np.where(narrow, col, out[:, k])
    if chroma:
        new = _wide(f, 2, 3, 1)
        for k, col in zip(range(4, 8), new):
            out[:, k] = np.where(wide8, col, out[:, k])
    else:
        new = _wide(f, 3, 3, 0)
        for k, col in zip(range(3, 9), new):
            out[:, k] = np.where(wide8, col, out[:, k])
        if wide16.any():
            new = _wide(f, 6, 4, 1)
            for k, col in zip(range(0, 12), new):
                out[:, k] = np.where(wide16, col, out[:, k])
    return out


def deblock(frame, planes: list) -> list:
    """Section 7.14 on the frame's planes (int32, the decoded area):
    returns the filtered planes."""
    if not frame.lf_levels[0] and not frame.lf_levels[1]:
        return planes
    seq = frame.seq
    levels = np.array(_levels(frame), np.int32)
    segments = np.array(frame.segment_ids, np.int32)
    out = []
    for plane, pixels in enumerate(planes):
        if plane and not frame.lf_levels[1 + plane]:
            out.append(pixels)
            continue
        subx = seq.subx if plane else 0
        suby = seq.suby if plane else 0
        rows4, cols4 = (frame.mi_rows >> suby), (frame.mi_cols >> subx)
        tx_w, tx_h = (a[:rows4, :cols4] for a in frame.lf_tx[plane])
        # The segment of each 4x4 of the plane: the mi at (row | suby, col | subx).
        seg = segments[(np.arange(rows4) << suby) | suby][:, (np.arange(cols4) << subx) | subx]
        # The edges on screen: their top-left luma sample inside the frame.
        ys = (np.arange(rows4) << suby) * 4 < frame.height
        xs = (np.arange(cols4) << subx) * 4 < frame.width
        padded = np.pad(pixels, 8, mode="edge").astype(np.int32)
        for direction in (0, 1):
            level = levels[:, plane + direction if plane == 0 else plane + 1][seg]
            tx_along = tx_w if direction == 0 else tx_h
            if direction:
                # Horizontal edges: the same as vertical ones of the transpose.
                padded, level, tx_along = padded.T.copy(), level.T, tx_along.T
                ys, xs = xs, ys
            for c in range(1, tx_along.shape[1]):
                if not xs[c]:
                    continue
                cur, prev = tx_along[:, c], tx_along[:, c - 1]
                edge = (4 * c) % cur == 0
                size = np.minimum(np.minimum(cur, prev), 8 if plane else 16)
                lvl = np.where(level[:, c] > 0, level[:, c], level[:, c - 1])
                size = np.where(edge & ys & (lvl > 0), size, 0)
                if not size.any():
                    continue
                size = np.repeat(size, 4)
                lvl = np.repeat(lvl, 4)
                x = 8 + 4 * c
                f = padded[8:-8, x - 7:x + 7]
                padded[8:-8, x - 6:x + 6] = _filter_edge(f, size, lvl, frame.lf_sharpness,
                                                         plane > 0, frame.seen)
            if direction:
                padded = padded.T.copy()
                ys, xs = xs, ys
        out.append(padded[8:-8, 8:-8])
    return out


def _partial_maps() -> np.ndarray:
    """For each of the 8 directions, the (64 x 15) map of an 8x8 block's
    pixels to the partial sums of cdef_direction (7.15.2)."""
    maps = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            pos = i * 8 + j
            for d, k in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j, 3 - i // 2 + j,
                                   j, i // 2 + j)):
                maps[d, pos, k] = 1
    return maps


_PARTIAL_MAPS = _partial_maps()


def _directions(blocks: np.ndarray) -> tuple:
    """cdef_direction for luma 8x8 blocks (n x 8 x 8): (direction,
    variance) of each."""
    x = blocks.reshape(len(blocks), 64).astype(np.int64) - 128
    partial = np.einsum("np,dpk->ndk", x, _PARTIAL_MAPS)
    div = T.CDEF_DIV_TABLE
    sq = partial * partial
    cost = np.zeros((len(blocks), 8), np.int64)
    cost[:, 2] = sq[:, 2, :8].sum(1) * div[8]
    cost[:, 6] = sq[:, 6, :8].sum(1) * div[8]
    for d in (0, 4):
        for i in range(7):
            cost[:, d] += (sq[:, d, i] + sq[:, d, 14 - i]) * div[i + 1]
        cost[:, d] += sq[:, d, 7] * div[8]
    for d in (1, 3, 5, 7):
        cost[:, d] = sq[:, d, 3:8].sum(1) * div[8]
        for j in range(3):
            cost[:, d] += (sq[:, d, j] + sq[:, d, 10 - j]) * div[2 * j + 2]
    # The first direction of the highest cost.
    best = np.argmax(cost, axis=1)
    rows = np.arange(len(blocks))
    best_cost = cost[rows, best]
    return best, (best_cost - cost[rows, (best + 4) & 7]) >> 10


def _constrain(diff, threshold, damping):
    """constrain(diff, threshold, damping) of 7.15.3, elementwise;
    ``threshold`` > 0."""
    log2 = np.floor(np.log2(np.maximum(threshold, 1))).astype(np.int64)
    adjust = np.maximum(0, damping - log2)
    magnitude = np.abs(diff)
    value = np.minimum(magnitude, np.maximum(0, threshold - (magnitude >> adjust)))
    return np.sign(diff) * value


def _filter_blocks(pixels, top, left, h, w, direction, pri, sec, damping):
    """cdef_filter for blocks of h x w at (top, left) of ``pixels`` (the
    decoded area of one plane), each with its direction and strengths:
    the filtered blocks (n x h x w). Taps outside the decoded area are
    not available."""
    n = len(top)
    big = 1 << 20
    padded = np.pad(pixels.astype(np.int64), 2, constant_values=big)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y = top[:, None, None] + ii + 2
    x = left[:, None, None] + jj + 2
    here = padded[y, x]
    total = np.zeros_like(here)
    high = here.copy()
    low = here.copy()
    dirs = np.array(T.CDEF_DIRECTIONS, np.int64)
    pri_taps = np.array(T.CDEF_PRI_TAPS, np.int64)[pri & 1]
    pri = pri[:, None, None]
    sec = sec[:, None, None]
    for k in range(2):
        for sign in (-1, 1):
            for which, offset in ((0, 0), (1, -2), (1, 2)):
                d = (direction + offset) & 7
                dy = sign * dirs[d, k, 0]
                dx = sign * dirs[d, k, 1]
                tap = padded[y + dy[:, None, None], x + dx[:, None, None]]
                usable = tap < big
                if which == 0:
                    weight = pri_taps[:, k][:, None, None]
                    value = weight * _constrain(tap - here, pri, damping)
                    value = np.where(pri > 0, value, 0)
                else:
                    value = T.CDEF_SEC_TAPS[k] * _constrain(tap - here, sec, damping)
                    value = np.where(sec > 0, value, 0)
                total += np.where(usable, value, 0)
                high = np.where(usable, np.maximum(high, tap), high)
                low = np.where(usable, np.minimum(low, tap), low)
    return np.clip(here + ((8 + total - (total < 0)) >> 4), low, high)


def cdef(frame, planes: list) -> list:
    """Section 7.15 on the deblocked planes: each 8x8 block of a 64x64
    whose cdef_idx is not -1, unless all four of its 4x4s are skipped,
    filtered with the strengths of that index."""
    seq = frame.seq
    skips = np.array(frame.skips, bool)
    blocks_skip = skips[0::2, 0::2] & skips[1::2, 0::2] & skips[0::2, 1::2] & skips[1::2, 1::2]
    rows8, cols8 = blocks_skip.shape
    index = np.array(frame.cdef_idx, np.int64)[np.arange(rows8) >> 3][:, np.arange(cols8) >> 3]
    by, bx = np.nonzero((index >= 0) & ~blocks_skip)
    frame.seen.add(f"cdef strengths {len(frame.cdef_strengths)}")
    if ((index < 0) & ~blocks_skip).any() or (blocks_skip & (index >= 0)).any():
        frame.seen.add("cdef skipped 8x8")
    if not len(by):
        return planes
    strengths = np.array(frame.cdef_strengths, np.int64)[index[by, bx]]
    y_pri, y_sec, uv_pri, uv_sec = strengths.T
    luma = planes[0]
    blocks = luma[(by * 8)[:, None, None] + np.arange(8)[None, :, None],
                  (bx * 8)[:, None, None] + np.arange(8)[None, None, :]]
    direction, variance = _directions(blocks)
    adjust = np.where(variance >> 6, np.minimum(
        np.floor(np.log2(np.maximum(variance >> 6, 1))).astype(np.int64), 12), 0)
    y_pri_adj = np.where(variance > 0, (y_pri * (4 + adjust) + 8) >> 4, 0)
    out = [p.copy() for p in planes]
    damping = frame.cdef_damping
    todo = (y_pri_adj > 0) | (y_sec > 0)
    if todo.any():
        sel = np.nonzero(todo)[0]
        y_dir = np.where(y_pri > 0, direction, 0)[sel]
        filtered = _filter_blocks(luma, by[sel] * 8, bx[sel] * 8, 8, 8, y_dir, y_pri_adj[sel],
                                  y_sec[sel], damping)
        out[0][(by[sel] * 8)[:, None, None] + np.arange(8)[None, :, None],
               (bx[sel] * 8)[:, None, None] + np.arange(8)[None, None, :]] = filtered
    if seq.num_planes > 1:
        subx, suby = seq.subx, seq.suby
        uv_dir = np.array(T.CDEF_UV_DIR[subx][suby], np.int64)[direction]
        uv_dir = np.where(uv_pri > 0, uv_dir, 0)
        todo = (uv_pri > 0) | (uv_sec > 0)
        if todo.any():
            sel = np.nonzero(todo)[0]
            h, w = 8 >> suby, 8 >> subx
            top, left = by[sel] * h, bx[sel] * w
            for plane in (1, 2):
                filtered = _filter_blocks(planes[plane], top, left, h, w, uv_dir[sel], uv_pri[sel],
                                          uv_sec[sel], damping - 1)
                out[plane][top[:, None, None] + np.arange(h)[None, :, None],
                           left[:, None, None] + np.arange(w)[None, None, :]] = filtered
    return out
