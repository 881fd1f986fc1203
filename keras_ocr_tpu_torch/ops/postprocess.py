"""CRAFT heatmaps -> word boxes on the device, batched.

Port of ``keras_ocr_tpu/ops/postprocess.py`` (``get_boxes``,
``component_analysis``, ``boxes_from_bank_extents``): threshold, 4-connected
components (:mod:`.cc`), per-(row, component) staircase tables, area and
confidence filters, the border-clipped analytic dilation, the 36-angle
min-area-rectangle bank with the near-square "diamond" fallback, and the
dilated-blob census behind the refine flag.

The JAX package builds its per-(row, segment) tables and per-pixel lookups
as one-hot ``(H, W, S)`` compare-and-reduce passes, because XLA:TPU
serialises scatters and dynamic gathers. Eager PyTorch would materialise
every one-hot plane (316 MB of float32 per reduce at 480x640 with S = 257),
so here the tables are ``scatter_reduce`` into ``(H, S)`` and the lookups
are gathers. Minima and maxima are exact and the sums count integers, so
the tables are the same numbers.
"""

from __future__ import annotations

import math

import torch

from .cc import brushfire_dilate, compact_labels, label_blobs_keyed, label_components

_BIG = 1e30


def _row_tables(ids, num_segments, extras=()):
    """Per-(row, segment) tables of (B, H, W) int segment ids.

    Returns count, xmin, xmax (B, H, S) float32 (+-_BIG where a segment is
    absent from a row) and one (B, H, S) row-maximum per extra map.
    """
    batch, height, width = ids.shape
    index = ids.to(torch.int64)
    shape = (batch, height, num_segments)
    cols = torch.arange(width, dtype=torch.float32, device=ids.device).expand(
        batch, height, width
    )
    count = torch.zeros(shape, dtype=torch.float32, device=ids.device).scatter_add_(
        2, index, torch.ones_like(cols)
    )

    def reduce(src, how, fill):
        table = torch.full(shape, fill, dtype=torch.float32, device=ids.device)
        return table.scatter_reduce_(2, index, src, how, include_self=True)

    xmin = reduce(cols, "amin", _BIG)
    xmax = reduce(cols, "amax", -_BIG)
    extra_maxs = [reduce(extra.to(torch.float32), "amax", -_BIG) for extra in extras]
    return count, xmin, xmax, extra_maxs


def _per_pixel(table, ids):
    """``table[b, ids[b, y, x]]`` for (B, S) tables and (B, H, W) ids."""
    flat = ids.flatten(1).to(torch.int64)
    return torch.gather(table, 1, flat).reshape(ids.shape)


def boxes_from_bank_extents(umin, umax, vmin, vmax, cos_k, sin_k, bl, bt, br, bb):
    """Directional extents -> min-area rectangles, reference-ordered.

    Args:
        umin/umax/vmin/vmax: (..., C, K) extents of each pixel set along
            the bank's (u, v) = (x cos + y sin, -x sin + y cos) axes.
        cos_k/sin_k: (K,) the bank directions.
        bl/bt/br/bb: (..., C) axis-aligned bbox for the near-square
            "diamond" fallback.

    Returns:
        (..., C, 4, 2) float32 corners, cyclic, min-(x+y) corner first.
    """
    rect_area = (umax - umin) * (vmax - vmin)
    best = torch.argmin(rect_area, dim=-1, keepdim=True)

    def pick(arr):
        return torch.gather(arr, -1, best)[..., 0]

    umin_b, umax_b = pick(umin), pick(umax)
    vmin_b, vmax_b = pick(vmin), pick(vmax)
    cos_t = cos_k[best[..., 0]]
    sin_t = sin_k[best[..., 0]]
    rw = umax_b - umin_b
    rh = vmax_b - vmin_b
    ratio = torch.maximum(rw, rh) / (torch.minimum(rw, rh) + 1e-5)
    diamond = torch.abs(1.0 - ratio) <= 0.1

    corners_u = torch.stack([umin_b, umax_b, umax_b, umin_b], -1)
    corners_v = torch.stack([vmin_b, vmin_b, vmax_b, vmax_b], -1)
    rot_x = corners_u * cos_t[..., None] - corners_v * sin_t[..., None]
    rot_y = corners_u * sin_t[..., None] + corners_v * cos_t[..., None]
    dia_x = torch.stack([bl, br, br, bl], -1)
    dia_y = torch.stack([bt, bt, bb, bb], -1)
    box_x = torch.where(diamond[..., None], dia_x, rot_x)
    box_y = torch.where(diamond[..., None], dia_y, rot_y)
    boxes = torch.stack([box_x, box_y], -1)  # (..., C, 4, 2)

    start = torch.argmin(box_x + box_y, dim=-1, keepdim=True)
    roll = (start + torch.arange(4, device=boxes.device)) % 4
    return torch.gather(boxes, -2, roll[..., None].expand(*roll.shape, 2))


def component_analysis(
    hm,
    detection_threshold,
    text_threshold,
    link_threshold,
    size_threshold,
    max_components,
    num_sweeps=8,
    per_component_census=False,
):
    """Per-component analysis of (B, H, W, 2) heatmaps.

    Returns the dict of ``keras_ocr_tpu/ops/postprocess.py:
    component_analysis``, each entry with a leading batch dimension. With
    ``per_component_census`` it holds ``n_dilblobs`` (B, C) float32 too:
    the 8-connected blobs of each component's dilated segmap, which the
    refine pass (:mod:`.refine`) reads to choose its components.
    """
    batch, height, width = hm.shape[:3]
    num_segments = max_components + 1  # last segment = dumped pixels
    device = hm.device

    textmap = hm[..., 0]
    linkmap = hm[..., 1]
    text_score = textmap > text_threshold
    link_score = linkmap > link_threshold
    fg = text_score | link_score

    label, label_converged = label_components(
        fg, num_sweeps=num_sweeps, check_convergence=True
    )
    comp, n_total, comp_converged = compact_labels(
        label, max_components, num_sweeps=num_sweeps, check_convergence=True
    )
    converged = label_converged & comp_converged

    # Segment ids for the overlap-removed segmap (detection.py:244-246).
    overlap = link_score & text_score
    segmask = fg & ~overlap
    seg2d = torch.where(overlap, torch.full_like(comp, max_components), comp)

    rows = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]

    cnt_full_r, xmin_full_r, xmax_full_r, (tmax_r,) = _row_tables(
        comp, num_segments, extras=(textmap,)
    )
    cnt_seg_r, xmin_seg_r, xmax_seg_r, _ = _row_tables(seg2d, num_segments)
    n_seg = cnt_seg_r.sum(1)[:, :-1]
    present_full = cnt_full_r > 0

    area = cnt_full_r.sum(1)[:, :-1]
    xmin = xmin_full_r.amin(1)[:, :-1]
    xmax = xmax_full_r.amax(1)[:, :-1]
    ymin = torch.where(present_full, rows, _BIG).amin(1)[:, :-1]
    ymax = torch.where(present_full, rows, -_BIG).amax(1)[:, :-1]
    tmax = tmax_r.amax(1)[:, :-1]
    bw = xmax - xmin + 1.0
    bh = ymax - ymin + 1.0
    valid0 = (area >= size_threshold) & (tmax >= detection_threshold)

    # Dilation kernel geometry (detection.py:258-264): square side 1+niter,
    # cv2 anchor (1+niter)//2: the set grows by `a` right/down, `b` left/up.
    niter = torch.floor(torch.sqrt(area * torch.minimum(bw, bh) / (bw * bh)) * 2.0)
    k = 1.0 + niter
    a = torch.floor(k / 2.0)
    b = k - 1.0 - a

    # Dilated-blob census (the contours[0] multi-blob flag).
    zero = torch.zeros((batch, 1), dtype=torch.float32, device=device)
    grow_a = _per_pixel(torch.cat([a, zero], 1), comp)
    grow_b = _per_pixel(torch.cat([b, zero], 1), comp)
    valid_ext = torch.cat([valid0.to(torch.float32), zero], 1)
    seeds = segmask & (_per_pixel(valid_ext, comp) > 0.5)
    cover, cover_comp = brushfire_dilate(seeds, comp, grow_a, grow_b)
    dil_label = label_blobs_keyed(cover, cover_comp, num_sweeps=num_sweeps)
    flat_idx = torch.arange(height * width, dtype=torch.int32, device=device).reshape(
        height, width
    )
    is_dilroot = (dil_label == flat_idx) & cover
    n_valid = (valid0 & (n_seg > 0)).sum(1, dtype=torch.int32)
    census_excess = is_dilroot.flatten(1).sum(1, dtype=torch.int32) - n_valid
    analysis = {
        "comp": comp,
        "overlap": overlap,
        "segmask": segmask,
        "n_total": n_total,
        "converged": converged,
        "census_excess": census_excess,
        "area": area,
        "xmin": xmin,
        "xmax": xmax,
        "ymin": ymin,
        "ymax": ymax,
        "tmax": tmax,
        "valid0": valid0,
        "niter": niter,
        "a": a,
        "b": b,
        "cnt_seg_r": cnt_seg_r,
        "xmin_seg_r": xmin_seg_r,
        "xmax_seg_r": xmax_seg_r,
        "n_seg": n_seg,
    }
    if per_component_census:
        # Blob roots counted per covering component; the last segment
        # (pixels outside the cover) is dropped.
        owner = torch.where(cover, cover_comp, torch.full_like(cover_comp, max_components))
        counts = torch.zeros((batch, num_segments), dtype=torch.float32, device=device)
        counts.scatter_add_(1, owner.flatten(1).to(torch.int64), is_dilroot.flatten(1).float())
        analysis["n_dilblobs"] = counts[:, :-1]
    return analysis


def _angle_bank(num_angles, device):
    """(cos, sin) float32 of the [0, 90) degree bank, rounded from float64
    and made on ``device`` (no host-to-device copy)."""
    alphas = torch.arange(num_angles, dtype=torch.float32, device=device)
    alphas = (alphas * (math.pi / 2.0 / num_angles)).to(torch.float64)
    return torch.cos(alphas).to(torch.float32), torch.sin(alphas).to(torch.float32)


def get_boxes(
    heatmaps,
    detection_threshold: float = 0.7,
    text_threshold: float = 0.4,
    link_threshold: float = 0.4,
    size_threshold: int = 10,
    max_components: int = 256,
    num_angles: int = 36,
    num_sweeps: int = 8,
    analysis=None,
):
    """Batched heatmaps -> (boxes, mask, diag).

    Args:
        heatmaps: (B, H, W, 2) float text/link maps.
        analysis: the :func:`component_analysis` of these heatmaps at these
            settings, where the caller has it already (the refine pass
            reads the same one); computed here otherwise.

    Returns:
        boxes: (B, max_components, 4, 2) float32 corners in input-image
            coordinates (heatmap coords x2), clockwise, min-(x+y) first.
        mask: (B, max_components) bool validity.
        diag: ``n_components`` (B,) int32 total thresholded components
            (before the capacity drop), ``converged`` (B,) bool labeling
            fixpoint proof, ``n_multiblob`` (B,) int32 excess dilated blobs.
    """
    height, width = heatmaps.shape[1:3]
    if analysis is None:
        analysis = component_analysis(
            heatmaps,
            detection_threshold,
            text_threshold,
            link_threshold,
            size_threshold,
            max_components,
            num_sweeps=num_sweeps,
        )
    a = analysis["a"]
    b = analysis["b"]
    cnt_seg_r = analysis["cnt_seg_r"]
    xmin_seg_r = analysis["xmin_seg_r"]
    xmax_seg_r = analysis["xmax_seg_r"]
    present_seg = cnt_seg_r > 0
    device = heatmaps.device

    cos_k, sin_k = _angle_bank(num_angles, device)
    rows = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]
    sxmin = xmin_seg_r.amin(1)[:, :-1]
    sxmax = xmax_seg_r.amax(1)[:, :-1]
    symin = torch.where(present_seg, rows, _BIG).amin(1)[:, :-1]
    symax = torch.where(present_seg, rows, -_BIG).amax(1)[:, :-1]

    # Border-clipped analytic Minkowski expansion: clamp the staircase
    # corners per (row, segment), then project onto the bank
    # (B, H, S, K); row extrema sit at the staircase columns because
    # cos, sin >= 0 on [0, 90).
    zero = torch.zeros_like(a[:, :1])
    ap = torch.cat([a, zero], 1)[:, None, :, None]
    bp = torch.cat([b, zero], 1)[:, None, :, None]
    p3 = present_seg[..., None]
    xg_hi = torch.clamp(xmax_seg_r[..., None] + ap, max=width - 1.0)
    xg_lo = torch.clamp(xmin_seg_r[..., None] - bp, min=0.0)
    y3 = rows[..., None]
    yg_hi = torch.clamp(y3 + ap, max=height - 1.0)
    yg_lo = torch.clamp(y3 - bp, min=0.0)

    def extent(proj, reducer, fill):
        return reducer(torch.where(p3, proj, fill), 1)[:, :-1]

    umax = extent(xg_hi * cos_k + yg_hi * sin_k, torch.amax, -_BIG)
    umin = extent(xg_lo * cos_k + yg_lo * sin_k, torch.amin, _BIG)
    vmax = extent(-xg_lo * sin_k + yg_hi * cos_k, torch.amax, -_BIG)
    vmin = extent(-xg_hi * sin_k + yg_lo * cos_k, torch.amin, _BIG)

    # Diamond-fallback bbox: exact bbox of the dilated segmap.
    dl = torch.clamp(sxmin - b, min=0.0)
    dt = torch.clamp(symin - b, min=0.0)
    dr = torch.clamp(sxmax + a, max=width - 1.0)
    db = torch.clamp(symax + a, max=height - 1.0)
    boxes = boxes_from_bank_extents(umin, umax, vmin, vmax, cos_k, sin_k, dl, dt, dr, db)

    valid = analysis["valid0"] & (analysis["n_seg"] > 0)
    boxes = torch.where(valid[..., None, None], boxes * 2.0, 0.0)
    diag = {
        "n_components": analysis["n_total"],
        "converged": analysis["converged"],
        "n_multiblob": analysis["census_excess"],
    }
    return boxes.to(torch.float32), valid, diag
