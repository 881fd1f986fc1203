"""Detector ground-truth heatmaps (``compute_maps``).

Port of ``keras_ocr_tpu/data/detection_targets.py``, numpy only and the
same arithmetic: for each fixed line of (character box, character), the
isotropic gaussian template is perspective-warped into the half-scale
character quad (text map) and into the quad joining consecutive character
centres (link map); spaces break links; horizontal and vertical lines are
both handled.
"""

from __future__ import annotations

import numpy as np

from .. import tools


def _accumulate_warp(canvas: np.ndarray, template: np.ndarray, dst_quad: np.ndarray):
    """canvas += template warped onto dst_quad (bounded to the quad bbox)."""
    height, width = canvas.shape
    src = np.array(
        [
            [0, 0],
            [template.shape[1], 0],
            [template.shape[1], template.shape[0]],
            [0, template.shape[0]],
        ],
        dtype="float32",
    )
    try:
        M = tools.get_perspective_transform(src, dst_quad.astype("float32"))
    except np.linalg.LinAlgError:
        return  # degenerate destination quad — see the skip note below
    # Only evaluate inside the quad's bounding box (big speedup over a
    # full-canvas warp; identical output since outside is zero).
    x0 = int(np.clip(np.floor(dst_quad[:, 0].min()), 0, width))
    x1 = int(np.clip(np.ceil(dst_quad[:, 0].max()) + 1, 0, width))
    y0 = int(np.clip(np.floor(dst_quad[:, 1].min()), 0, height))
    y1 = int(np.clip(np.ceil(dst_quad[:, 1].max()) + 1, 0, height))
    if x1 <= x0 or y1 <= y0:
        return
    # Degenerate quads (collinear/coincident corners — e.g. the link quad
    # of two tiny overlapping character boxes at small font sizes) have a
    # singular homography. cv2.warpPerspective inverts M internally and
    # silently produces an empty patch in that case (the reference's
    # behavior at detection.py:177-190), so skipping is the faithful
    # equivalent of "no contribution", not a semantic change.
    try:
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return
    if not np.isfinite(Minv).all():
        return
    xs, ys = np.meshgrid(
        np.arange(x0, x1, dtype="float64"), np.arange(y0, y1, dtype="float64")
    )
    denom = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    sx = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / denom
    sy = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / denom
    x0i = np.floor(sx).astype("int64")
    y0i = np.floor(sy).astype("int64")
    fx = sx - x0i
    fy = sy - y0i
    th, tw = template.shape

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < tw) & (yy >= 0) & (yy < th)
        vals = template[np.clip(yy, 0, th - 1), np.clip(xx, 0, tw - 1)]
        return np.where(inside, vals, 0.0)

    patch = (
        tap(y0i, x0i) * (1 - fx) * (1 - fy)
        + tap(y0i, x0i + 1) * fx * (1 - fy)
        + tap(y0i + 1, x0i) * (1 - fx) * fy
        + tap(y0i + 1, x0i + 1) * fx * fy
    )
    canvas[y0:y1, x0:x1] += patch.astype("float32")


def compute_maps(heatmap: np.ndarray, image_height: int, image_width: int, lines):
    """Build the (H/2, W/2, 2) text/link target from character lines.

    Raises ``ValueError`` on an odd height or width (the JAX package
    asserts).
    """
    if image_height % 2:
        raise ValueError("Height must be an even number")
    if image_width % 2:
        raise ValueError("Width must be an even number")

    textmap = np.zeros((image_height // 2, image_width // 2), dtype="float32")
    linkmap = np.zeros_like(textmap)
    template = heatmap.astype("float32")

    for line in lines:
        line, orientation = tools.fix_line(line)
        previous_link_points = None
        for box, character in line:
            (x1, y1), (x2, y2), (x3, y3), (x4, y4) = np.clip(
                np.asarray(box, dtype="float64"), 0, None
            )
            if character == " ":
                previous_link_points = None
                continue
            yc = (y1 + y2 + y3 + y4) / 4
            xc = (x1 + x2 + x3 + x4) / 4
            if orientation == "horizontal":
                current_link_points = (
                    np.array(
                        [
                            [(xc + (x1 + x2) / 2) / 2, (yc + (y1 + y2) / 2) / 2],
                            [(xc + (x3 + x4) / 2) / 2, (yc + (y3 + y4) / 2) / 2],
                        ]
                    )
                    / 2
                )
            else:
                current_link_points = (
                    np.array(
                        [
                            [(xc + (x1 + x4) / 2) / 2, (yc + (y1 + y4) / 2) / 2],
                            [(xc + (x2 + x3) / 2) / 2, (yc + (y2 + y3) / 2) / 2],
                        ]
                    )
                    / 2
                )
            character_points = (
                np.array([[x1, y1], [x2, y2], [x3, y3], [x4, y4]], dtype="float32") / 2
            )
            if previous_link_points is not None:
                if orientation == "horizontal":
                    link_points = np.array(
                        [
                            previous_link_points[0],
                            current_link_points[0],
                            current_link_points[1],
                            previous_link_points[1],
                        ]
                    )
                else:
                    link_points = np.array(
                        [
                            previous_link_points[0],
                            previous_link_points[1],
                            current_link_points[1],
                            current_link_points[0],
                        ]
                    )
                _accumulate_warp(linkmap, template, link_points)
            _accumulate_warp(textmap, template, character_points)
            previous_link_points = current_link_points
    return np.clip(np.stack([textmap, linkmap], axis=-1), 0, 255) / 255


def map_to_rgb(y: np.ndarray) -> np.ndarray:
    """(H, W, 2) float map -> displayable RGB."""
    return (
        np.concatenate([y, np.zeros((y.shape[0], y.shape[1], 1))], axis=-1) * 255
    ).astype("uint8")
