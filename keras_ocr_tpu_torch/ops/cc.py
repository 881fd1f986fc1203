"""Connected-component labeling on (B, H, W) tensors.

Port of ``keras_ocr_tpu/ops/cc.py``. Every foreground pixel starts with its
flat index as its label and min-label propagation across foreground runs
(:func:`segmented_min_sweeps`, the CUDA kernel on the card) spreads each
component's minimum. Each function takes a batch: every leading dimension
is an independent image, and a 2-D input is one image.
"""

from __future__ import annotations

import torch

from .cc_cuda import _shift, keyed_rows_cols, segmented_min_sweeps

__all__ = [
    "segmented_min_sweeps",
    "label_components",
    "compact_labels",
    "brushfire_dilate",
    "label_blobs_keyed",
    "label_components_8conn",
    "flood_from_seeds",
]


def _flat_index(height, width, device):
    return torch.arange(height * width, dtype=torch.int32, device=device).reshape(
        height, width
    )


def label_components(fg, num_sweeps=8, check_convergence=False):
    """4-connected component labels of a (..., H, W) bool mask.

    Returns (..., H, W) int32: the flat index of the component's minimum
    pixel (its root) at foreground pixels, ``H * W`` at background; with
    ``check_convergence`` a (labels, converged) tuple.
    """
    height, width = fg.shape[-2:]
    sentinel = height * width
    idx = _flat_index(height, width, fg.device)
    label = torch.where(fg, idx, torch.full_like(idx, sentinel))
    return segmented_min_sweeps(
        label, ~fg, sentinel, num_sweeps, check_convergence=check_convergence
    )


def compact_labels(label, max_components, num_sweeps=8, check_convergence=False):
    """Compact root labels to dense component ids in raster order.

    The compact id is written at each root pixel (a cumsum over the root
    indicator) and propagated to the rest of the component by the same
    sweeps, as in the JAX package, so ``converged`` means the same thing.

    Returns:
        comp: (..., H, W) int32 in [0, max_components) at foreground pixels
            of kept components, ``max_components`` otherwise.
        num_components: (...) int32 total roots found.
        With ``check_convergence``, additionally (...) bool ``converged``.
    """
    height, width = label.shape[-2:]
    sentinel = height * width
    flat = label.flatten(-2)
    idx = torch.arange(sentinel, dtype=torch.int32, device=label.device)
    is_root = flat == idx
    order = torch.cumsum(is_root.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    fg = (flat < sentinel).reshape(label.shape)
    seeded = torch.where(is_root, order, torch.full_like(order, sentinel))
    seeded = seeded.reshape(label.shape)
    seeded = torch.where(fg, seeded, torch.full_like(seeded, sentinel))
    result = segmented_min_sweeps(
        seeded, ~fg, sentinel, num_sweeps, check_convergence=check_convergence
    )
    comp, converged = result if check_convergence else (result, None)
    comp = torch.where(
        fg & (comp < max_components), comp, torch.full_like(comp, max_components)
    )
    n_total = is_root.sum(-1, dtype=torch.int32)
    if check_convergence:
        return comp, n_total, converged
    return comp, n_total


def _prefix_max_payload(measure, payloads, dim, reverse, fill):
    """Running (prefix) max of ``measure`` along ``dim`` with payloads.

    Hillis-Steele doubling; ``payloads`` ride along with the winning
    position. ``reverse=True`` scans from the high end (suffix max).
    """
    distance = 1
    size = measure.shape[dim]
    while distance < size:
        ms = _shift(measure, distance, dim, reverse, fill)
        take = ms > measure
        measure = torch.maximum(measure, ms)
        payloads = [
            torch.where(take, _shift(p, distance, dim, reverse, 0), p)
            for p in payloads
        ]
        distance *= 2
    return measure, payloads


def brushfire_dilate(seed, comp, grow_a, grow_b):
    """Per-component square dilation of ``seed`` on (..., H, W) planes.

    The union over seed pixels p of ``[px - b_p, px + a_p] x [py - b_p,
    py + a_p]`` clipped at the border, by separable max-plus prefix scans;
    see ``keras_ocr_tpu/ops/cc.py:brushfire_dilate`` for why contested
    pixels can only over-count blobs.

    Returns (cover (..., H, W) bool, cover_comp (..., H, W) int32, -1
    outside the cover).
    """
    neg = -3e9

    def axis_pass(active, acomp, a_bud, b_bud, dim):
        size = active.shape[dim]
        pos = torch.arange(size, dtype=torch.float32, device=active.device)
        pos = pos.reshape(-1, 1) if dim == -2 else pos.reshape(1, -1)
        pos = pos.expand(active.shape[-2:])
        mf, (cf, af, bf) = _prefix_max_payload(
            torch.where(active, pos + a_bud, torch.full_like(a_bud, neg)),
            [acomp, a_bud, b_bud], dim, reverse=False, fill=neg,
        )
        covered_f = mf >= pos
        mb, (cb, ab, bb) = _prefix_max_payload(
            torch.where(active, b_bud - pos, torch.full_like(b_bud, neg)),
            [acomp, a_bud, b_bud], dim, reverse=True, fill=neg,
        )
        covered_b = mb >= -pos
        covered = covered_f | covered_b
        ncomp = torch.where(covered_f, cf, cb)
        na = torch.where(covered_f, af, ab)
        nb = torch.where(covered_f, bf, bb)
        # Seeds of THIS pass always keep their own identity.
        ncomp = torch.where(active, acomp, ncomp)
        na = torch.where(active, a_bud, na)
        nb = torch.where(active, b_bud, nb)
        return covered, ncomp, na, nb

    covered, ncomp, na, nb = axis_pass(seed, comp, grow_a, grow_b, dim=-1)
    covered, ncomp, _, _ = axis_pass(covered, ncomp, na, nb, dim=-2)
    return covered, torch.where(covered, ncomp, torch.full_like(ncomp, -1))


_DIAGONALS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _shift2(arr, dy, dx, fill):
    """Bring the element at offset (-dy, -dx); edges filled with ``fill``."""
    out = arr
    if dy:
        out = _shift(out, abs(dy), -2, dy < 0, fill)
    if dx:
        out = _shift(out, abs(dx), -1, dx < 0, fill)
    return out


def label_blobs_keyed(mask, key, num_sweeps=8, check_convergence=False):
    """8-connected blob labels within ``mask``, segmented by ``key``.

    Two adjacent (8-neighbourhood) mask pixels join a blob only when their
    ``key`` values match. The row and column runs go through the sweep
    kernel's keyed mode (:func:`.cc_cuda.keyed_rows_cols`); the diagonal
    step is plain PyTorch.

    Returns (..., H, W) int32 root-flat-index labels (sentinel at
    background); with ``check_convergence`` a (labels, converged) tuple.
    """
    height, width = mask.shape[-2:]
    sentinel = height * width
    idx = _flat_index(height, width, mask.device)
    label = torch.where(mask, idx, torch.full_like(idx, sentinel))

    def diagonal_step(lab):
        best = lab
        for dy, dx in _DIAGONALS:
            cand = _shift2(lab, dy, dx, sentinel)
            cand = torch.where(
                _shift2(key, dy, dx, -2) == key, cand, torch.full_like(cand, sentinel)
            )
            best = torch.minimum(best, cand)
        return torch.where(mask, best, torch.full_like(best, sentinel))

    def sweep(lab):
        return diagonal_step(keyed_rows_cols(lab, key, mask, sentinel))

    return _iterate(sweep, label, num_sweeps, check_convergence)


def _iterate(sweep, label, num_sweeps, check_convergence):
    """``num_sweeps`` applications of ``sweep``; with ``check_convergence``
    one more, and per image whether it changed nothing."""
    out = label
    for _ in range(num_sweeps):
        out = sweep(out)
    if check_convergence:
        final = sweep(out)
        return final, (final == out).flatten(-2).all(-1)
    return out


def label_components_8conn(fg, num_sweeps=8, comp=None, check_convergence=False):
    """8-connected component labels of a (..., H, W) bool mask.

    Each sweep is one call of :func:`segmented_min_sweeps` (the row and
    column runs, the sweep kernel on the card) followed by a min over the
    four diagonal neighbours, which bridges the diagonal adjacencies the
    runs cannot cross. With ``comp`` ((..., H, W) int32 4-connected
    component ids) a diagonal bridge needs equal ``comp`` on both ends, so
    each component's blobs are labelled on their own.

    Returns (..., H, W) int32 root-flat-index labels (the root is a blob's
    raster-first pixel; ``H * W`` at background); with
    ``check_convergence`` a (labels, (...) bool converged) tuple.
    """
    height, width = fg.shape[-2:]
    sentinel = height * width
    idx = _flat_index(height, width, fg.device)
    label = torch.where(fg, idx, torch.full_like(idx, sentinel))
    barrier = ~fg

    def diagonal_step(lab):
        best = lab
        for dy, dx in _DIAGONALS:
            cand = _shift2(lab, dy, dx, sentinel)
            if comp is not None:
                cand = torch.where(
                    _shift2(comp, dy, dx, -1) == comp, cand, torch.full_like(cand, sentinel)
                )
            best = torch.minimum(best, cand)
        return torch.where(barrier, torch.full_like(best, sentinel), best)

    def sweep(lab):
        return diagonal_step(segmented_min_sweeps(lab, barrier, sentinel, 1))

    return _iterate(sweep, label, num_sweeps, check_convergence)


def flood_from_seeds(mask, seeds, num_sweeps=8, check_convergence=False):
    """4-connected reach inside ``mask`` from ``seeds`` ((..., H, W) bool).

    With ``mask`` the background of a blob plane and ``seeds`` its
    border-adjacent background, the result is the background that is not a
    hole (what ``scipy.ndimage.binary_fill_holes`` leaves unfilled). One
    :func:`segmented_min_sweeps` call of ``num_sweeps`` sweeps: seeds start
    at 0, and a pixel is reached when the 0 has spread to it.

    Returns (..., H, W) bool; with ``check_convergence`` a (reached, (...)
    bool converged) tuple.
    """
    sentinel = mask.shape[-2] * mask.shape[-1]
    zero = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    values = torch.where(seeds & mask, zero, zero + sentinel)
    out = segmented_min_sweeps(
        values, ~mask, sentinel, num_sweeps, check_convergence=check_convergence
    )
    if check_convergence:
        out, converged = out
        return (out == 0) & mask, converged
    return (out == 0) & mask
