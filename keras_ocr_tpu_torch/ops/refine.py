"""Windowed contours[0] refinement of multi-blob components (tier 2).

Port of ``keras_ocr_tpu/ops/refine.py``. The reference fits its rectangle
to the first contour ``cv2.findContours`` returns on a component's dilated
segmap: among the top-level blobs, the one whose raster-first pixel comes
last. Tier 1 (:func:`.postprocess.get_boxes`) fits the whole dilated set,
which is exact when that set is one blob; the census counts the blobs per
component, and the components with more than one are re-fit here:

* each gets a window around its reference ROI, cut from the component and
  overlap planes at a clipped origin (an ``unfold`` view and one gather for
  the whole (B, R) batch of slots, R = min(``refine_cap``, C));
* its segmap is dilated in the window by the cv2 square with its
  asymmetric anchor, by per-slot amounts (a nearest-set-pixel distance
  from a running max, exact where the JAX package doubles rolls), and
  intersected with the ROI;
* blobs are labelled 8-connected and the background flooded 4-connected
  from the window border and the outside of the ROI, both through the sweep
  kernel on the card; a blob is top-level when the pixel above its root is
  flooded background or its root sits on the ROI's top row;
* the top-level blob with the largest root index is fit with the angle bank.

Every slot is computed, active or not, with no host synchronisation and no
shape that depends on the data. ``refine_ok`` is False where the window,
the dilation budget or either propagation falls short, or more components
are flagged than there are slots: callers climb :data:`LADDER` and finally
fall back on the exact host oracle.
"""

from __future__ import annotations

import torch

from .cc import _shift2, flood_from_seeds, label_components_8conn
from .postprocess import _BIG, _angle_bank, boxes_from_bank_extents, component_analysis

# Escalation ladder of the callers: (window_h, window_w, max_dilate,
# num_iters, refine_cap). Windows are clamped to the heatmap, so the last
# level always covers it.
LADDER = (
    (128, 512, 32, 16, 8),
    (512, 1024, 64, 32, 16),
    (4096, 4096, 128, 64, 32),
)

_FAR = 1 << 30


def _grow(mask, amount, dim, forward):
    """Grow a (..., H, W) bool ``mask`` by ``amount`` pixels along ``dim``
    (-1 or -2), toward higher indices when ``forward``; ``amount`` is int32
    with size 1 along H and W (one amount a map). A pixel is covered when
    the nearest set pixel behind it (ahead of it when not ``forward``) lies
    within ``amount``, so growth stops at the window edge."""
    pos = torch.arange(mask.shape[dim], dtype=torch.int32, device=mask.device)
    if dim == -2:
        pos = pos[:, None]
    if forward:
        nearest = torch.where(mask, pos, -_FAR).cummax(dim).values
        return pos - nearest <= amount
    nearest = torch.where(mask, pos, _FAR).flip(dim).cummin(dim).values.flip(dim)
    return nearest - pos <= amount


def refine_boxes(
    heatmaps,
    boxes,
    detection_threshold: float = 0.7,
    text_threshold: float = 0.4,
    link_threshold: float = 0.4,
    size_threshold: int = 10,
    max_components: int = 256,
    num_angles: int = 36,
    num_sweeps: int = 8,
    refine_cap: int = 8,
    window_h: int = 128,
    window_w: int = 512,
    max_dilate: int = 32,
    num_iters: int = 16,
    analysis=None,
):
    """Replace flagged components' tier-1 boxes with exact contours[0] fits.

    Args:
        heatmaps: (B, H, W, 2) CRAFT heatmaps (those tier 1 saw).
        boxes: (B, max_components, 4, 2) tier-1 boxes to patch.
        analysis: :func:`.postprocess.component_analysis` of these heatmaps
            at these settings with ``per_component_census=True``, where the
            caller has it; computed here otherwise.

    Returns:
        boxes: patched (B, max_components, 4, 2).
        refine_ok: (B,) bool, every flagged component of the image refined
            with all proofs holding; False asks for the next level.
        n_flagged: (B,) int32 flagged components (may exceed ``refine_cap``).
    """
    batch, height, width = heatmaps.shape[:3]
    window_h = min(window_h, height)
    window_w = min(window_w, width)
    device = heatmaps.device
    if analysis is None:
        analysis = component_analysis(
            heatmaps, detection_threshold, text_threshold, link_threshold,
            size_threshold, max_components, num_sweeps=num_sweeps,
            per_component_census=True,
        )

    need = analysis["valid0"] & (analysis["n_dilblobs"] > 1.5)  # (B, C)
    n_flagged = need.sum(1, dtype=torch.int32)
    # Flagged slots first, by component id.
    order = torch.argsort((~need).to(torch.int8), dim=1, stable=True)
    slot_comp = order[:, :refine_cap]  # (B, R)
    slot_active = torch.gather(need, 1, slot_comp)

    def take(name):
        return torch.gather(analysis[name], 1, slot_comp)

    # The reference ROI around each component.
    niter = take("niter")
    sx = torch.clamp(take("xmin") - niter, min=0.0)
    sy = torch.clamp(take("ymin") - niter, min=0.0)
    ex = torch.clamp(take("xmax") + niter + 2.0, max=float(width))
    ey = torch.clamp(take("ymax") + niter + 2.0, max=float(height))
    a_c, b_c = take("a"), take("b")
    fits = (
        (ey - sy <= window_h) & (ex - sx <= window_w)
        & (a_c <= max_dilate) & (b_c <= max_dilate)
    )

    # Window origins, clipped so the window stays in the heatmap (empty
    # slots hold huge extents and land at the far edge).
    oy = sy.clamp(0.0, float(height - window_h)).to(torch.int64)
    ox = sx.clamp(0.0, float(width - window_w)).to(torch.int64)
    images = torch.arange(batch, device=device)[:, None]

    def windows(plane):
        view = plane.unfold(1, window_h, 1).unfold(2, window_w, 1)
        return view[images, oy, ox]  # (B, R, window_h, window_w)

    rows = torch.arange(window_h, device=device)
    cols = torch.arange(window_w, device=device)
    abs_r = (oy[..., None] + rows).to(torch.float32)  # (B, R, window_h)
    abs_c = (ox[..., None] + cols).to(torch.float32)  # (B, R, window_w)
    roi = (
        ((abs_r >= sy[..., None]) & (abs_r < ey[..., None]))[..., :, None]
        & ((abs_c >= sx[..., None]) & (abs_c < ex[..., None]))[..., None, :]
    )
    seg = (
        (windows(analysis["comp"]) == slot_comp[..., None, None])
        & ~windows(analysis["overlap"])
        & roi
    )

    # cv2 square dilation: a toward +x/+y, b toward -x/-y, within the ROI.
    # (The JAX package's doubling stops at 2**bits - 1 pixels; a slot whose
    # budget passes max_dilate fails ``fits`` in both.)
    a_i = a_c.to(torch.int32)[..., None, None]
    b_i = b_c.to(torch.int32)[..., None, None]
    m = _grow(seg, a_i, -1, True)
    m = _grow(m, b_i, -1, False)
    m = _grow(m, a_i, -2, True)
    m = _grow(m, b_i, -2, False)
    m = m & roi

    label, conv8 = label_components_8conn(m, num_sweeps=num_iters, check_convergence=True)
    bg = ~m
    border = ((rows == 0) | (rows == window_h - 1))[:, None] | (
        (cols == 0) | (cols == window_w - 1)
    )[None, :]
    reached, conv_flood = flood_from_seeds(
        bg, bg & (~roi | border), num_sweeps=num_iters, check_convergence=True
    )

    # contours[0]: the top-level blob whose root comes last in raster order.
    flat = torch.arange(window_h * window_w, dtype=torch.int32, device=device)
    flat = flat.reshape(window_h, window_w)
    is_root = (label == flat) & m
    top_ok = (abs_r == sy[..., None])[..., :, None] | _shift2(reached, 1, 0, False)
    chosen = torch.where(is_root & top_ok, flat, -1).flatten(-2).amax(-1)  # (B, R)
    sel = m & (label == chosen[..., None, None])

    # The angle-bank fit on the chosen blob's pixels.
    present = sel.any(-1)  # (B, R, window_h)
    colsf = abs_c[..., None, :]
    rxmin = torch.where(sel, colsf, _BIG).amin(-1)
    rxmax = torch.where(sel, colsf, -_BIG).amax(-1)
    cos_k, sin_k = _angle_bank(num_angles, device)
    pk = present[..., None]
    lo, hi, y = rxmin[..., None], rxmax[..., None], abs_r[..., None]
    umax = torch.where(pk, hi * cos_k + y * sin_k, -_BIG).amax(-2)  # (B, R, K)
    umin = torch.where(pk, lo * cos_k + y * sin_k, _BIG).amin(-2)
    vmax = torch.where(pk, -lo * sin_k + y * cos_k, -_BIG).amax(-2)
    vmin = torch.where(pk, -hi * sin_k + y * cos_k, _BIG).amin(-2)
    left = torch.where(present, rxmin, _BIG).amin(-1)
    right = torch.where(present, rxmax, -_BIG).amax(-1)
    top = torch.where(present, abs_r, _BIG).amin(-1)
    bottom = torch.where(present, abs_r, -_BIG).amax(-1)
    refined = boxes_from_bank_extents(
        umin, umax, vmin, vmax, cos_k, sin_k, left, top, right, bottom
    ) * 2.0
    ok = fits & conv8 & conv_flood & (chosen >= 0)

    index = slot_comp[..., None, None].expand(-1, -1, 4, 2)
    use = (slot_active & ok)[..., None, None]
    rows_out = torch.where(use, refined.to(boxes.dtype), torch.gather(boxes, 1, index))
    boxes = boxes.scatter(1, index, rows_out)
    refine_ok = (ok | ~slot_active).all(1) & (n_flagged <= refine_cap)
    return boxes, refine_ok, n_flagged
