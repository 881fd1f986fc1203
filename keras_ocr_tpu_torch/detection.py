"""Text detection of the port: the CRAFT facade, ``Detector.detect`` and the
host oracle.

Counterpart of ``keras_ocr_tpu/detection.py``: ``compute_input``,
``getBoxes`` (the reference's algorithm on the host, exact: the oracle the
device post-processing is held to, and its fallback), ``boxes_from_mask``
and ``Detector`` with ``heatmaps`` and ``detect``; for training
``get_gaussian_heatmap``, ``compute_maps`` and ``Detector.compile`` /
``get_batch_generator``. Where the JAX package's
oracle calls scipy, this one labels with the plain CPU versions of
:mod:`.ops.cc`, run to their fixpoint.
"""

from __future__ import annotations

import typing
import warnings

import numpy as np
import torch

from . import tools
from . import weights as weights_lib
from .data.detection_targets import compute_maps
from .models import CRAFT, init_parameters
from .models.craft import fold_bn_state_dict
from .ops import cc as cc_ops
from .ops import image as image_ops
from .ops import postprocess as postprocess_ops
from .ops import refine as refine_ops

# Ceiling of the component-cap escalation: the staircase tables are
# O(H x cap), so this bounds memory on noise-saturated heatmaps.
MAX_COMPONENTS_CEILING = 1024
# Ceiling of the labeling-sweep escalation; real heatmaps converge in 1-2
# sweeps and every call proves convergence. An image still unconverged here
# falls back on the host oracle.
MAX_SWEEPS_CEILING = 64
DEFAULT_NUM_SWEEPS = 8


def default_device() -> torch.device:
    """The first GPU; raises where there is none, so that nothing runs on
    the CPU unless the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


def compute_input(image):
    """Host numpy ImageNet normalisation of RGB images in [0, 255]."""
    image = np.asarray(image).astype("float32")
    mean = np.array([0.485, 0.456, 0.406])
    variance = np.array([0.229, 0.224, 0.225])
    return (image - mean * 255) / (variance * 255)


def get_gaussian_heatmap(size=512, distanceRatio=3.34):
    """Isotropic 2-D gaussian template (uint8) for the detector's targets."""
    v = np.abs(np.linspace(-size / 2, size / 2, num=size))
    x, y = np.meshgrid(v, v)
    g = np.sqrt(x**2 + y**2)
    g *= distanceRatio / (size / 2)
    g = np.exp(-(1 / 2) * (g**2))
    g *= 255
    return g.clip(0, 255).astype("uint8")


def _dilate_cv2_style(mask: np.ndarray, niter: int) -> np.ndarray:
    """Dilation of a bool mask by the (1+niter)^2 square with cv2's anchor:
    the set grows by ``k//2`` toward +x/+y and ``k-1-k//2`` toward -x/-y,
    clipped at the border (one pass per axis)."""
    k = 1 + niter
    a = k // 2
    b = k - 1 - a
    out = mask
    for axis in (0, 1):
        grown = out.copy()
        size = out.shape[axis]
        for d in range(-b, a + 1):
            if d:  # source p lights destination p + d
                dst = [slice(None)] * 2
                src = [slice(None)] * 2
                dst[axis] = slice(max(d, 0), size + min(d, 0))
                src[axis] = slice(max(-d, 0), size + min(-d, 0))
                grown[tuple(dst)] |= out[tuple(src)]
        out = grown
    return out


def _to_fixpoint(fn, *args):
    """``fn(*args, num_sweeps=s, check_convergence=True)`` with ``s``
    doubled from 8 until every image converged; the outputs without the
    flag."""
    sweeps = DEFAULT_NUM_SWEEPS
    while True:
        *out, converged = fn(*args, num_sweeps=sweeps, check_convergence=True)
        if bool(converged.all()):
            return out[0] if len(out) == 1 else out
        sweeps *= 2


def _label_components(mask: np.ndarray) -> typing.Tuple[np.ndarray, int]:
    """4-connected labels 1..n of a bool mask in raster order of each
    component's first pixel (``scipy.ndimage.label``'s numbering), 0 at
    background."""
    label = _to_fixpoint(cc_ops.label_components, torch.from_numpy(mask))
    comp, count = _to_fixpoint(cc_ops.compact_labels, label, mask.size)
    comp = comp.numpy()
    return np.where(mask, comp + 1, 0), int(count)


def _first_contour_pixels(mask: np.ndarray) -> np.ndarray:
    """Pixels behind ``cv2.findContours(mask, RETR_TREE, ...)[0]``.

    Parents precede their children in cv2's list, and among top-level outer
    borders the order is reverse raster discovery: ``contours[0]`` is the
    top-level 8-connected blob whose raster-first pixel comes last. A blob
    is not top-level when that pixel lies in a hole of another blob (its
    background not 4-connected to the border). A border has its blob's hull
    and extrema, so the blob's pixels are returned; a one-blob mask as it is.
    """
    height, width = mask.shape
    labels = _to_fixpoint(cc_ops.label_components_8conn, torch.from_numpy(mask)).numpy()
    roots = np.flatnonzero((labels.ravel() == np.arange(mask.size)) & mask.ravel())
    if len(roots) <= 1:
        return mask
    blobs = labels[None] == roots[:, None, None]  # (n, H, W), roots ascending
    background = torch.from_numpy(~blobs)
    border = torch.zeros((height, width), dtype=torch.bool)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    reached = _to_fixpoint(cc_ops.flood_from_seeds, background, background & border)
    filled = ~reached.numpy()  # each blob with its holes
    best_index, best = -1, mask
    for i, root in enumerate(roots):
        top, seed_x = divmod(int(root), width)
        nested = filled[:, top, seed_x].copy()
        nested[i] = False
        if not nested.any() and root > best_index:
            best_index, best = root, blobs[i]
    return best


def getBoxes(
    y_pred,
    detection_threshold=0.7,
    text_threshold=0.4,
    link_threshold=0.4,
    size_threshold=10,
):
    """Host heatmaps -> rotated word boxes, one (N, 4, 2) float32 array per
    image: threshold, 4-connected components, area and peak-confidence
    filters, the overlap-removed segmap, the per-component square dilation
    inside its ROI, contours[0], the min-area rectangle with the
    near-square "diamond" fallback, the min-(x+y) corner first, x2.

    Each component is worked in its ROI window: its dilation never reaches
    the window's inner edges, and its blobs' holes are the same there.
    """
    box_groups = []
    for heatmaps in y_pred:
        textmap = np.asarray(heatmaps[..., 0])
        linkmap = np.asarray(heatmaps[..., 1])
        img_h, img_w = textmap.shape
        text_score = textmap > text_threshold
        link_score = linkmap > link_threshold
        overlap = text_score & link_score
        labels, n_components = _label_components(text_score | link_score)
        ys, xs = np.nonzero(labels)
        ids = labels[ys, xs]
        order = np.argsort(ids, kind="stable")
        starts = np.searchsorted(ids[order], np.arange(1, n_components + 2))
        boxes = []
        for component_id in range(1, n_components + 1):
            members = order[starts[component_id - 1] : starts[component_id]]
            cys, cxs = ys[members], xs[members]
            size = len(members)
            if size < size_threshold:
                continue
            if textmap[cys, cxs].max() < detection_threshold:
                continue
            x, y = cxs.min(), cys.min()
            w, h = cxs.max() - x + 1, cys.max() - y + 1
            niter = int(np.sqrt(size * min(w, h) / (w * h)) * 2)
            sx, sy = max(x - niter, 0), max(y - niter, 0)
            ex, ey = min(x + w + niter + 1, img_w), min(y + h + niter + 1, img_h)
            window = (slice(sy, ey), slice(sx, ex))
            segmap = (labels[window] == component_id) & ~overlap[window]
            dilated = _dilate_cv2_style(segmap, niter)
            pys, pxs = np.nonzero(_first_contour_pixels(dilated))
            if len(pxs) == 0:
                continue
            pxs, pys = pxs + sx, pys + sy
            points = np.stack([pxs, pys], axis=1).astype("float32")
            box = tools.min_area_rect(points)
            bw = np.linalg.norm(box[0] - box[1])
            bh = np.linalg.norm(box[1] - box[2])
            box_ratio = max(bw, bh) / (min(bw, bh) + 1e-5)
            if abs(1 - box_ratio) <= 0.1:
                l, r = pxs.min(), pxs.max()
                t, b = pys.min(), pys.max()
                box = np.array([[l, t], [r, t], [r, b], [l, b]], dtype="float32")
            else:
                box = np.array(np.roll(box, 4 - box.sum(axis=1).argmin(), 0))
            boxes.append(2 * box)
        box_groups.append(
            np.array(boxes, dtype="float32") if boxes else np.zeros((0, 4, 2), "float32")
        )
    return box_groups


def boxes_from_mask(boxes, mask) -> typing.List[np.ndarray]:
    """Fixed-shape (B, C, 4, 2) boxes and their (B, C) mask -> one (N, 4, 2)
    float32 array per image."""
    return [
        image_boxes[image_mask].astype("float32")
        for image_boxes, image_mask in zip(np.asarray(boxes), np.asarray(mask))
    ]


class Detector:
    """CRAFT text detector.

    Args:
        weights: name of published pretrained weights. Their loaders are
            not ported yet, so only ``None`` (seeded random weights, or a
            variable tree passed to :meth:`load_variables`) is accepted.
        width: channel multiplier (1.0 = the reference graph).
        max_components: starting cap of the component escalation.
        fold_bn: build the inference graph with BatchNorm folded into the
            convolutions; on the card its convs run through the CUDA
            chain kernel (:mod:`keras_ocr_tpu_torch.ops.conv_cuda`).
        device: where the model runs (default: the first GPU; without
            one, pass ``device="cpu"`` or the constructor raises).
        seed: seed of the random initialisation.
    """

    def __init__(
        self,
        weights: typing.Optional[str] = None,
        width: float = 1.0,
        max_components: int = 256,
        fold_bn: bool = False,
        device=None,
        seed: int = 0,
    ):
        if width != 1.0 and weights is not None:
            raise ValueError(f"width={width} has no pretrained weights; pass weights=None")
        if weights is not None:
            raise NotImplementedError(
                f"pretrained weights {weights!r} cannot be loaded yet; use "
                "weights=None and load_variables()"
            )
        self.width = width
        self.max_components = max_components
        self.fold_bn = fold_bn
        self.device = torch.device(device) if device is not None else default_device()
        model = init_parameters(CRAFT(width=width, fold_bn=fold_bn), seed=seed)
        self.model = model.to(self.device).eval()

    def load_variables(self, variables: dict) -> "Detector":
        """Load a JAX-package CRAFT variable tree (numpy leaves). With
        ``fold_bn`` a standard tree is folded on load, as the JAX
        ``Detector`` folds the weights it loads; a folded tree loads as is."""
        state = weights_lib.craft_state_dict(variables)
        if self.fold_bn:
            state = fold_bn_state_dict(state)
        self.model.load_state_dict(state)
        return self

    @torch.inference_mode()
    def heatmaps(self, images_array) -> np.ndarray:
        """Raw (B, H/2, W/2, 2) heatmaps of a normalised (B, H, W, 3) batch."""
        x = torch.as_tensor(np.asarray(images_array), dtype=torch.float32)
        return self.model(x.to(self.device)).cpu().numpy()

    @torch.inference_mode()
    def detect(
        self,
        images: typing.List[typing.Union[np.ndarray, str]],
        detection_threshold=0.7,
        text_threshold=0.4,
        link_threshold=0.4,
        size_threshold=10,
        use_device_postprocess: bool = True,
        **kwargs,
    ) -> typing.List[np.ndarray]:
        """Word boxes of same-size images; one (N, 4, 2) array per image.

        The images are read, uploaded as they are (uint8 for decoded
        files), normalised on the detector's device and run through CRAFT.
        Then ``get_boxes`` climbs its sweep and component ladders and, where
        a component's dilated segmap is several blobs, the refine ladder
        (:data:`.ops.refine.LADDER`). An image whose result cannot be proven
        exact even at the top of those ladders takes the host oracle
        :func:`getBoxes`, with a warning. ``use_device_postprocess=False``
        runs the oracle on every image.
        """
        if not len(images):
            return []
        batch = torch.from_numpy(np.stack([np.asarray(tools.read(image)) for image in images]))
        heatmaps = self.model(image_ops.compute_input(batch.to(self.device)))
        thresholds = dict(
            detection_threshold=detection_threshold,
            text_threshold=text_threshold,
            link_threshold=link_threshold,
            size_threshold=size_threshold,
        )
        if not use_device_postprocess:
            return getBoxes(heatmaps.cpu().numpy(), **thresholds)
        # The labeling proves its convergence and counts every component:
        # a serpentine scene escalates the sweeps, a busy one the cap.
        cap = self.max_components
        sweeps = DEFAULT_NUM_SWEEPS
        while True:
            settings = dict(thresholds, max_components=cap, num_sweeps=sweeps)
            analysis = postprocess_ops.component_analysis(
                heatmaps, **settings, per_component_census=True
            )
            boxes, mask, diag = postprocess_ops.get_boxes(heatmaps, **settings, analysis=analysis)
            found = int(diag["n_components"].max())
            converged = diag["converged"].cpu().numpy()
            if not converged.all() and sweeps < MAX_SWEEPS_CEILING:
                sweeps = min(sweeps * 2, MAX_SWEEPS_CEILING)
                continue
            if found > cap and cap < MAX_COMPONENTS_CEILING:
                cap = min(cap * 2, MAX_COMPONENTS_CEILING)
                continue
            if found > cap:
                warnings.warn(
                    f"{found} thresholded components exceed the "
                    f"{MAX_COMPONENTS_CEILING} device cap; extra components "
                    "were dropped. Use use_device_postprocess=False for this image.",
                    stacklevel=2,
                )
            break

        # Multi-blob components (the contours[0] case): patch them with the
        # exact windowed fit, up the (window, iterations, cap) ladder.
        needs_host = ~converged
        if int(diag["n_multiblob"].max()) > 0:
            for wh, ww, md, it, rc in refine_ops.LADDER:
                boxes, refine_ok, _ = refine_ops.refine_boxes(
                    heatmaps, boxes, **settings, refine_cap=rc, window_h=wh,
                    window_w=ww, max_dilate=md, num_iters=it, analysis=analysis,
                )
                refine_ok = refine_ok.cpu().numpy()
                if refine_ok.all():
                    break
            needs_host = needs_host | ~refine_ok

        groups = boxes_from_mask(boxes.cpu().numpy(), mask.cpu().numpy())
        if needs_host.any():
            # Not provably exact on the device even at the ladders' tops:
            # the exact host oracle replaces those images' results.
            warnings.warn(
                "device post-processing could not prove exactness for "
                f"{int(needs_host.sum())} image(s) (labeling convergence or "
                "contours[0] refinement); falling back to host post-processing "
                "for them.",
                stacklevel=2,
            )
            bad = np.flatnonzero(needs_host)
            for index, host in zip(bad, getBoxes(heatmaps.cpu().numpy()[bad], **thresholds)):
                groups[index] = host
        return groups

    def compile(self, optimizer=None, learning_rate: float = 1e-3, mesh=None):
        """Create (and return, as ``self.trainer``) the MSE trainer of this
        detector: ``optimizer`` is a callable from parameters to a
        ``torch.optim.Optimizer``, by default Adam at ``learning_rate``
        (the reference's ``compile(loss="mse", optimizer="adam")``). Train
        with ``self.trainer.fit(...)``."""
        from .train import DetectorTrainer
        from .train.optim import adam

        if optimizer is None:
            def optimizer(params):
                return adam(params, lr=learning_rate)
        self.trainer = DetectorTrainer(self, optimizer=optimizer, mesh=mesh)
        return self.trainer

    def get_batch_generator(self, image_generator, batch_size=8, heatmap_size=512,
                            heatmap_distance_ratio=1.5):
        """Training batches ``(X, y)``, or ``(X, y, sample_weights)`` from
        samples with a third element, from ``(image, lines[, weight])``
        samples of same-size uint8 RGB images: X is the normalised batch, y
        the (B, H/2, W/2, 2) text and link maps of :func:`compute_maps`."""
        heatmap = get_gaussian_heatmap(size=heatmap_size, distanceRatio=heatmap_distance_ratio)
        while True:
            batch = [next(image_generator) for _ in range(batch_size)]
            images = np.array([entry[0] for entry in batch])
            X = compute_input(images)
            y = np.array([
                compute_maps(heatmap=heatmap, image_height=images.shape[1],
                             image_width=images.shape[2], lines=entry[1])
                for entry in batch
            ])
            if len(batch[0]) == 3:
                yield X, y, np.array([sample[2] for sample in batch])
            else:
                yield X, y
