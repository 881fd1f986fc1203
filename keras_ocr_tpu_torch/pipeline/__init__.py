"""End-to-end OCR pipeline of the port: detection -> crop -> recognition.

Counterpart of ``keras_ocr_tpu/pipeline/__init__.py:Pipeline``. The device
program (:meth:`Pipeline._device_pipeline`) runs the 2x upscale and
normalisation, CRAFT, ``get_boxes`` (and, at a refine level above 0, the
contours[0] refinement of :mod:`..ops.refine`), word compaction, grayscale
and the perspective crops, the CRNN and the greedy CTC decode on the
pipeline's device, and returns one packed ``(B, words, 8+1+T+2)`` float32
tensor with the JAX layout: 8 box coordinates, the slot's validity, T
decoded labels, the total thresholded components, and a flag bitmask (+1
labeling converged, +2 a multi-blob component wants, or failed, contours[0]
refinement, +4 a crop overflowed the warp window). PyTorch launches
asynchronously; the host waits for the device only when it fetches that
tensor, and the escalation ladders (sweeps, components, word buckets,
refine, warp) relaunch the program on the flags it reads. Images whose
longest side times ``scale`` passes ``max_size`` are resized on the host
(:func:`..tools.resize_image`), as in the JAX package.

``recognize(..., recognition_kwargs=...)`` takes the two-stage path
instead: host resize and pad, :meth:`..detection.Detector.detect` on the
device, host crops and the recognizer on the device
(:meth:`..recognition.Recognizer.recognize_from_boxes`), so that per-call
recognizer options apply.

:meth:`Pipeline.export` traces the device program at one static shape with
``torch.export`` (the kernels are the ``torch.ops.keras_ocr_tpu_torch`` ops,
one opaque node a launch) into ``<path>.pt2``, weights inside, and writes
the host metadata to ``<path>.json``; :func:`load_exported` loads it into an
:class:`ExportedPipeline`, which serves it without the model classes. Not
ported yet: meshes.
"""

from __future__ import annotations

import json
import threading
import typing
import warnings

import numpy as np
import torch

from .. import detection as detection_mod
from .. import tools
from ..detection import Detector
from ..ops import ctc as ctc_ops
from ..ops import postprocess as postprocess_ops
from ..ops import refine as refine_ops
from ..ops.image import compute_input, resize_bilinear, rgb_to_grayscale
from ..ops.warp import WINDOW_LADDER, warp_boxes_batch, window_overflow
from ..recognition import Recognizer


def _new_run_stats():
    return {
        "escalations": 0,
        "truncated_images": 0,
        "component_escalations": 0,
        "sweep_escalations": 0,
        "refine_escalations": 0,
        "warp_escalations": 0,
    }


def device_program(
    craft,
    crnn,
    crop_shape,
    images,  # (B, H, W, 3) uint8 on the device
    detection_threshold,
    text_threshold,
    link_threshold,
    size_threshold,
    max_components,
    max_words,
    resize_to=None,
    num_sweeps=detection_mod.DEFAULT_NUM_SWEEPS,
    refine_level=0,  # 1-based index into ops.refine.LADDER
    warp_level=0,
    detector_chunk=16,
):
    """The fused device program on (B, H, W, 3) uint8 ``images``, with
    ``craft`` and ``crnn`` the two models and ``crop_shape`` the
    recognizer's (height, width, channels); returns the packed
    (B, words, 8+1+T+2) float32 tensor. It sets no grad mode of its own:
    :meth:`Pipeline._device_pipeline` runs it under inference mode, and
    :meth:`Pipeline.export` traces it. ``detector_chunk`` bounds the CRAFT
    batch (the full-resolution activations of large batches)."""
    images = images.to(torch.float32)
    if resize_to is not None:
        images = resize_bilinear(images, resize_to[0], resize_to[1])
    x = compute_input(images)
    heatmaps = torch.cat([craft(chunk) for chunk in torch.split(x, detector_chunk)])
    settings = dict(
        detection_threshold=detection_threshold,
        text_threshold=text_threshold,
        link_threshold=link_threshold,
        size_threshold=size_threshold,
        max_components=max_components,
        num_sweeps=num_sweeps,
    )
    # One component analysis serves tier 1 and the refine pass.
    analysis = postprocess_ops.component_analysis(
        heatmaps, **settings, per_component_census=refine_level > 0
    )
    boxes, mask, diag = postprocess_ops.get_boxes(heatmaps, **settings, analysis=analysis)
    if refine_level > 0:
        # The contours[0] pass; the signal is now its proofs failing.
        wh, ww, md, it, rc = refine_ops.LADDER[refine_level - 1]
        boxes, refine_ok, _ = refine_ops.refine_boxes(
            heatmaps, boxes, **settings, refine_cap=rc, window_h=wh, window_w=ww,
            max_dilate=md, num_iters=it, analysis=analysis,
        )
        refine_signal = ~refine_ok
    else:
        refine_signal = diag["n_multiblob"] > 0
    # Compact valid boxes into the first max_words slots (stable order).
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :max_words]
    boxes_c = torch.gather(boxes, 1, order[..., None, None].expand(-1, -1, 4, 2))
    mask_c = torch.gather(mask, 1, order)

    win_h, win_w = WINDOW_LADDER[warp_level]
    warp_signal = window_overflow(boxes_c, mask_c, win_h, win_w)

    height, width, channels = crop_shape
    if channels == 1:
        # Grayscale before warping, as the reference converts on host.
        source = torch.clamp(rgb_to_grayscale(images), 0, 255)
        crops = warp_boxes_batch(
            source, boxes_c, target_height=height, target_width=width,
            window_height=win_h, window_width=win_w,
        )
        crops = (crops / 255.0)[..., None]
    else:
        crops = warp_boxes_batch(
            images, boxes_c, target_height=height, target_width=width,
            window_height=win_h, window_width=win_w,
        ) / 255.0
    batch, words = crops.shape[:2]
    probs = crnn(crops.reshape((batch * words,) + crops.shape[2:]))
    decoded = ctc_ops.ctc_greedy_decode(probs).reshape(batch, words, -1)
    flags = (
        diag["converged"].to(torch.float32)
        + 2.0 * refine_signal.to(torch.float32)
        + 4.0 * warp_signal.to(torch.float32)
    )
    per_image = torch.stack([diag["n_components"].to(torch.float32), flags], -1)
    return torch.cat(
        [
            boxes_c.reshape(batch, words, 8),
            mask_c[..., None].to(torch.float32),
            decoded.to(torch.float32),
            per_image[:, None, :].expand(batch, words, 2),
        ],
        dim=-1,
    )


class Pipeline:
    """A detector and a recognizer fused into one device program.

    Args:
        detector / recognizer: default to seeded random-weight models on
            the first GPU (raises without one: pass models built with
            ``device="cpu"`` to run on the CPU).
        scale: the scale factor applied to input images.
        max_size: the maximum single-side dimension of scaled images.
        max_words: cap on recognized words per image.
        size_bucket: pad image sides up to multiples of this.
        pad_to: optional (height, width) every batch is padded to.
        word_buckets: increasing word-capacity ladder ending at
            ``max_words`` (default ``(16, max_words)``).
    """

    def __init__(
        self,
        detector: typing.Optional[Detector] = None,
        recognizer: typing.Optional[Recognizer] = None,
        scale: int = 2,
        max_size: int = 2048,
        max_words: int = 64,
        size_bucket: int = 32,
        pad_to: typing.Optional[typing.Tuple[int, int]] = None,
        word_buckets: typing.Optional[typing.Sequence[int]] = None,
    ):
        if detector is None:
            detector = Detector()
        if recognizer is None:
            recognizer = Recognizer(device=detector.device)
        if recognizer.device != detector.device:
            raise ValueError(
                f"detector on {detector.device} but recognizer on {recognizer.device}"
            )
        self.device = detector.device
        self.scale = scale
        self.detector = detector
        self.recognizer = recognizer
        self.max_size = max_size
        self.max_words = max_words
        if word_buckets is None:
            word_buckets = (16, max_words) if max_words > 16 else (max_words,)
        if word_buckets[-1] != max_words or list(word_buckets) != sorted(set(word_buckets)):
            raise ValueError(
                "word_buckets must be strictly increasing and end at "
                f"max_words={max_words}; got {tuple(word_buckets)}"
            )
        self.word_buckets = tuple(int(b) for b in word_buckets)
        # Sticky caps are performance memos, never correctness state: each
        # result is judged against the caps it was launched with.
        self._component_cap = detector.max_components
        self._num_sweeps = detection_mod.DEFAULT_NUM_SWEEPS
        self._bucket_start = 0
        self._sticky_lock = threading.Lock()
        self.last_run_stats = _new_run_stats()
        self.size_bucket = size_bucket
        self.pad_to = pad_to
        # Sub-batch of the CRAFT forward: bounds the full-resolution
        # activations of large batches.
        self._detector_chunk = 16

    @torch.inference_mode()
    def _device_pipeline(self, images, *args, **kwargs):
        """:func:`device_program` of this pipeline's models on (B, H, W, 3)
        uint8 ``images`` on the device, under inference mode."""
        return device_program(
            self.detector.model, self.recognizer.model, self.recognizer.input_shape,
            images, *args, detector_chunk=self._detector_chunk, **kwargs,
        )

    def _prepare(self, images):
        """Host prep: read and pad to one uint8 batch, upload to the device.

        Returns (device_batch, scales, num_real, resize_to). The upload goes
        from pinned memory without blocking the host.
        """
        if not isinstance(images, np.ndarray):
            images = [tools.read(image) for image in images]
        scales = [
            self.max_size / max(image.shape)
            if max(image.shape) * self.scale > self.max_size
            else self.scale
            for image in images
        ]
        if len(set(scales)) == 1 and float(scales[0]).is_integer():
            # Ship the small uint8 originals; the device upscales them.
            upscale = int(scales[0])
            max_height = max(image.shape[0] for image in images)
            max_width = max(image.shape[1] for image in images)
            if self.pad_to is not None:
                if self.pad_to[0] < max_height or self.pad_to[1] < max_width:
                    raise ValueError(
                        f"pad_to {self.pad_to} smaller than batch extent "
                        f"({max_height}, {max_width})"
                    )
                max_height, max_width = self.pad_to
        else:
            # A fractional or mixed scale: resize on the host (cv2
            # INTER_LINEAR), and pad in resized space.
            images, scales, (max_height, max_width) = self._resize_on_host(images)
            upscale = None
        batch = self._pad_batch(images, max_height, max_width)
        max_height, max_width = batch.shape[1:3]
        host = torch.from_numpy(batch)
        if self.device.type == "cuda":
            host = host.pin_memory()
        device_batch = host.to(self.device, non_blocking=True)
        resize_to = None if upscale is None else (max_height * upscale, max_width * upscale)
        return device_batch, scales, len(batch), resize_to

    def _resize_on_host(self, images):
        """Resize each image on the host (:func:`..tools.resize_image`);
        returns the images, their scales and the (height, width) to pad
        to: the batch extent, or ``pad_to`` times ``scale``, which raises
        when it is smaller."""
        resized = [
            tools.resize_image(image, max_scale=self.scale, max_size=self.max_size)
            for image in images
        ]
        images = [image for image, _ in resized]
        max_height = max(image.shape[0] for image in images)
        max_width = max(image.shape[1] for image in images)
        if self.pad_to is not None:
            target_h, target_w = self.pad_to[0] * self.scale, self.pad_to[1] * self.scale
            if target_h < max_height or target_w < max_width:
                raise ValueError(
                    f"pad_to {self.pad_to} (x{self.scale}) smaller than "
                    f"resized batch extent ({max_height}, {max_width})"
                )
            max_height, max_width = target_h, target_w
        return images, [scale for _, scale in resized], (max_height, max_width)

    def _pad_batch(self, images, max_height, max_width):
        """One (B, H, W, 3) uint8 array: each image padded with 255 at the
        bottom and right to the extent rounded up to ``size_bucket``."""
        bucket = self.size_bucket
        max_height = -(-max_height // bucket) * bucket
        max_width = -(-max_width // bucket) * bucket
        return np.array(
            [tools.pad(image, width=max_width, height=max_height) for image in images],
            dtype="uint8",
        )

    def _raise_sticky(self, component_cap=None, num_sweeps=None, bucket_start=None):
        """Publish learned caps monotonically (thread-safe)."""
        with self._sticky_lock:
            if component_cap is not None:
                self._component_cap = max(self._component_cap, component_cap)
            if num_sweeps is not None:
                self._num_sweeps = max(self._num_sweeps, num_sweeps)
            if bucket_start is not None:
                self._bucket_start = bucket_start

    def _launch(
        self, device_batch, detection_kwargs, bucket, resize_to, components,
        sweeps=detection_mod.DEFAULT_NUM_SWEEPS, refine_level=0, warp_level=0,
    ):
        """Enqueue the device program at one set of caps and levels;
        returns the packed device tensor without waiting for it."""
        return self._device_pipeline(
            device_batch,
            detection_threshold=float(detection_kwargs.get("detection_threshold", 0.7)),
            text_threshold=float(detection_kwargs.get("text_threshold", 0.4)),
            link_threshold=float(detection_kwargs.get("link_threshold", 0.4)),
            size_threshold=float(detection_kwargs.get("size_threshold", 10)),
            max_components=components,
            max_words=bucket,
            resize_to=resize_to,
            num_sweeps=sweeps,
            refine_level=refine_level,
            warp_level=warp_level,
        )

    def _fetch_escalating(
        self,
        packed_dev,
        device_batch,
        detection_kwargs,
        resize_to,
        num_real,
        bucket,
        components,
        sweeps=detection_mod.DEFAULT_NUM_SWEEPS,
        stats=None,
    ):
        """Fetch a launched result; relaunch on the sweep, component,
        word-bucket, refine and warp ladders. ``components``/``sweeps`` are
        the caps ``packed_dev`` was launched with."""
        if stats is None:
            stats = self.last_run_stats
        remaining = list(self.word_buckets[self.word_buckets.index(bucket) + 1 :])

        def fetch(packed):
            return packed[:num_real].cpu().numpy()

        def relaunch(refine_level=0, warp_level=0):
            return fetch(
                self._launch(
                    device_batch, detection_kwargs, bucket, resize_to,
                    components, sweeps, refine_level, warp_level,
                )
            )

        packed = fetch(packed_dev)

        def flag_bits(bit):
            """Any image with ``bit`` set in its flags (bit 1 inverted:
            set means converged)."""
            if not len(packed):
                return False
            flags = packed[:, 0, -1].astype(int)
            if bit == 1:
                return bool(((flags & 1) == 0).any())
            return bool((flags & bit).any())

        # Convergence first: an unconverged labeling may split components
        # and overcount ncomp, which the component check reads.
        while flag_bits(1) and sweeps < detection_mod.MAX_SWEEPS_CEILING:
            sweeps = min(sweeps * 2, detection_mod.MAX_SWEEPS_CEILING)
            self._raise_sticky(num_sweeps=sweeps)
            stats["sweep_escalations"] += 1
            packed = relaunch()
        if flag_bits(1):
            warnings.warn(
                f"component labeling did not converge within "
                f"{detection_mod.MAX_SWEEPS_CEILING} sweeps; serpentine "
                "components may be split. Use Detector.detect(use_device_postprocess="
                "False) for this image.",
                stacklevel=3,
            )
        while (
            len(packed)
            and int(packed[:, 0, -2].max()) > components
            and components < detection_mod.MAX_COMPONENTS_CEILING
        ):
            components = min(components * 2, detection_mod.MAX_COMPONENTS_CEILING)
            self._raise_sticky(component_cap=components)
            stats["component_escalations"] += 1
            packed = relaunch()
        while bool((packed[..., 8] > 0.5).all(axis=1).any()) and remaining:
            bucket = remaining.pop(0)
            stats["escalations"] += 1
            packed = relaunch()
        # contours[0] refinement (flag 2): rerun with the tier-2 pass, up its
        # (window, iterations, cap) ladder until its proofs hold. Not sticky:
        # multi-blob components are rare, and a sticky level would add the
        # pass to every later call.
        refine_level = 0
        while flag_bits(2) and refine_level < len(refine_ops.LADDER):
            refine_level += 1
            stats["refine_escalations"] += 1
            packed = relaunch(refine_level)
        if flag_bits(2):
            warnings.warn(
                "contours[0] refinement incomplete at the ladder top; "
                "multi-blob component boxes may be supersets. Use "
                "Detector.detect(use_device_postprocess=False) for this "
                "image.",
                stacklevel=3,
            )
        # Warp-window overflow: rerun with the next window rung so crops
        # stay exact slices; the top rung accepts the antialiased downscale.
        warp_level = 0
        while flag_bits(4) and warp_level < len(WINDOW_LADDER) - 1:
            warp_level += 1
            stats["warp_escalations"] += 1
            packed = relaunch(refine_level, warp_level)
        saturated = int((packed[..., 8] > 0.5).all(axis=1).sum()) if len(packed) else 0
        if saturated:
            stats["truncated_images"] += saturated
            warnings.warn(
                f"{saturated} image(s) filled all max_words={self.max_words} "
                "word slots; results may be truncated. Raise Pipeline("
                "max_words=...) for denser scenes.",
                stacklevel=3,
            )
        word_count = int((packed[..., 8] > 0.5).sum(axis=1).max()) if len(packed) else 0
        self._raise_sticky(
            bucket_start=next(
                (i for i, b in enumerate(self.word_buckets) if b > word_count),
                len(self.word_buckets) - 1,
            )
        )
        return packed

    def _finalize(self, packed, scales):
        """Unpack the fetched (B, words, 8+1+T+2) array into the ragged API."""
        boxes = packed[..., :8].reshape(packed.shape[0], packed.shape[1], 4, 2)
        mask = packed[..., 8] > 0.5
        decoded = packed[..., 9:-2].astype("int32")
        results = []
        for i, scale in enumerate(scales):
            valid = mask[i]
            words = ctc_ops.ctc_decode_to_strings(decoded[i][valid], self.recognizer.alphabet)
            image_boxes = boxes[i][valid].astype("float32")
            if scale != 1:
                image_boxes = image_boxes / scale
            results.append(list(zip(words, [box for box in image_boxes])))
        return results

    def _start(self, images, detection_kwargs):
        """Prepare and launch one batch; returns what the fetch needs."""
        device_batch, scales, num_real, resize_to = self._prepare(images)
        bucket = self.word_buckets[self._bucket_start]
        components = self._component_cap
        sweeps = self._num_sweeps
        packed_dev = self._launch(
            device_batch, detection_kwargs, bucket, resize_to, components, sweeps
        )
        return packed_dev, device_batch, resize_to, num_real, scales, bucket, components, sweeps

    def _finish(self, started, detection_kwargs, stats):
        packed_dev, device_batch, resize_to, num_real, scales, bucket, components, sweeps = started
        packed = self._fetch_escalating(
            packed_dev, device_batch, detection_kwargs, resize_to, num_real,
            bucket, components, sweeps, stats=stats,
        )
        return self._finalize(packed, scales)

    def recognize(
        self,
        images,
        detection_kwargs: typing.Optional[dict] = None,
        recognition_kwargs: typing.Optional[dict] = None,
    ):
        """Run the fused pipeline; returns a list of (word, box) lists.

        Non-empty ``recognition_kwargs`` go to
        :meth:`Recognizer.recognize_from_boxes` and take the two-stage path
        (:meth:`_recognize_two_stage`), since the fused program has the
        recognizer call built in.
        """
        detection_kwargs = dict(detection_kwargs or {})
        stats = _new_run_stats()
        self.last_run_stats = stats
        if recognition_kwargs:
            return self._recognize_two_stage(images, detection_kwargs, dict(recognition_kwargs))
        results = self._finish(self._start(images, detection_kwargs), detection_kwargs, stats)
        self.last_run_stats = stats
        return results

    def _recognize_two_stage(self, images, detection_kwargs, recognition_kwargs):
        """Host resize (``tools.resize_image``, at any scale) and pad with
        the fused path's shape policy, ``Detector.detect``, then
        ``Recognizer.recognize_from_boxes(**recognition_kwargs)`` on the
        padded batch; boxes are divided by each image's scale."""
        if not isinstance(images, np.ndarray):
            images = [tools.read(image) for image in images]
        resized, scales, extent = self._resize_on_host(images)
        batch = self._pad_batch(resized, *extent)
        box_groups = self.detector.detect(images=batch, **detection_kwargs)
        prediction_groups = self.recognizer.recognize_from_boxes(
            images=batch, box_groups=box_groups, **recognition_kwargs
        )
        return [
            list(zip(predictions, boxes / scale if scale != 1 else boxes))
            for predictions, boxes, scale in zip(prediction_groups, box_groups, scales)
        ]

    def recognize_many(
        self,
        images,
        batch_size: int = 8,
        detection_kwargs: typing.Optional[dict] = None,
        queue_depth: int = 2,
    ):
        """Throughput-oriented recognize: batches of ``batch_size`` with up
        to ``queue_depth`` device programs in flight, so the host prepares
        and launches batch i+1 while the device runs batch i. Output is
        identical to ``recognize`` called per batch."""
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        detection_kwargs = dict(detection_kwargs or {})
        stats = _new_run_stats()
        self.last_run_stats = stats
        images = list(images)
        inflight: typing.List[tuple] = []
        results: typing.List[list] = []
        for start in range(0, len(images), batch_size):
            inflight.append(self._start(images[start : start + batch_size], detection_kwargs))
            if len(inflight) >= queue_depth:
                results.extend(self._finish(inflight.pop(0), detection_kwargs, stats))
        while inflight:
            results.extend(self._finish(inflight.pop(0), detection_kwargs, stats))
        self.last_run_stats = stats
        return results

    def export(
        self,
        path: str,
        height: int,
        width: int,
        batch_size: int = 1,
        detection_kwargs: typing.Optional[dict] = None,
        max_words: typing.Optional[int] = None,
        platforms: typing.Optional[typing.Sequence[str]] = None,
        refine_level: int = 1,
    ) -> str:
        """Serialize the fused pipeline for serving, weights inside.

        Writes ``<path>.pt2``, a ``torch.export`` program of the whole
        device program (normalize, CRAFT, ``get_boxes``, refine, crops,
        CRNN, CTC) at one static input shape, its kernels as the
        ``torch.ops.keras_ocr_tpu_torch`` ops, and ``<path>.json`` with the
        host metadata that serves it. Reload with :func:`load_exported`.

        Args:
            height/width: pre-scale input image shape the artifact serves
                (images are padded to it by the serving wrapper).
            batch_size: static batch the artifact serves.
            platforms: ``None`` or this pipeline's own device type: the
                traced graph holds its device's constants and is never
                re-targeted.
            refine_level: contours[0] pass baked into the program (1-based
                index into ``ops.refine.LADDER``, clamped; 0 = tier 1 only).
                Components its proofs cannot handle surface as
                ``refine_pending`` in :meth:`ExportedPipeline.recognize`.

        The warp window is the first ``WINDOW_LADDER`` rung that holds the
        whole scaled envelope (every crop then takes the exact slice path),
        else the top rung, whose oversized crops take its antialiased
        downscale and are flagged ``warp_downscaled``; the component cap is
        the detector's and the sweeps ``DEFAULT_NUM_SWEEPS``: the artifact
        has no escalation relaunches.
        """
        if isinstance(platforms, str):
            platforms = [platforms]
        if platforms is not None and set(platforms) != {self.device.type}:
            raise ValueError(
                f"a pipeline on {self.device} exports for platforms "
                f"[{self.device.type!r}] only, not {list(platforms)}"
            )
        detection_kwargs = dict(detection_kwargs or {})
        max_words = max_words or self.max_words
        refine_level = max(0, min(int(refine_level), len(refine_ops.LADDER)))
        resize_to = (height * self.scale, width * self.scale)
        warp_level = next(
            (
                level
                for level, (wh, ww) in enumerate(WINDOW_LADDER)
                if wh >= resize_to[0] + 3 and ww >= resize_to[1] + 3
            ),
            len(WINDOW_LADDER) - 1,
        )
        settings = dict(
            detection_threshold=float(detection_kwargs.get("detection_threshold", 0.7)),
            text_threshold=float(detection_kwargs.get("text_threshold", 0.4)),
            link_threshold=float(detection_kwargs.get("link_threshold", 0.4)),
            size_threshold=float(detection_kwargs.get("size_threshold", 10)),
            max_components=self.detector.max_components,
            max_words=max_words,
            resize_to=resize_to,
            num_sweeps=detection_mod.DEFAULT_NUM_SWEEPS,
            refine_level=refine_level,
            warp_level=warp_level,
            detector_chunk=self._detector_chunk,
        )
        program = _ServedProgram(
            self.detector.model, self.recognizer.model, self.recognizer.input_shape, settings
        )
        example = torch.zeros((batch_size, height, width, 3), dtype=torch.uint8, device=self.device)
        with torch.no_grad(), warnings.catch_warnings():
            # Export swaps the parameters for traced ones, and nn.LSTM's
            # setattr hook reassigns its ``_flat_weights`` list to follow;
            # export restores every attribute afterwards and the graph reads
            # the lifted parameters, so the artifact computes what the live
            # program does (the tests hold the two bit for bit).
            warnings.filterwarnings("ignore", message=r"The tensor attributes? .*_flat_weights")
            exported = torch.export.export(program, (example,), strict=False)
        torch.export.save(exported, path + ".pt2")
        build = self.recognizer.build_params
        meta = {
            "alphabet": self.recognizer.alphabet,
            "scale": self.scale,
            "height": height,
            "width": width,
            "batch_size": batch_size,
            "max_words": max_words,
            "ctc_time": int(
                build["width"] // build["pool_size"] ** 2 - build["rnn_steps_to_discard"]
            ),
            "refine_level": refine_level,
            "warp_level": warp_level,
            "device": str(self.device),
        }
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        return path + ".pt2"


class _ServedProgram(torch.nn.Module):
    """The two models as submodules, and :func:`device_program` at baked
    settings as ``forward``: what :meth:`Pipeline.export` traces."""

    def __init__(self, craft, crnn, crop_shape, settings):
        super().__init__()
        self.craft = craft
        self.crnn = crnn
        self.crop_shape = tuple(crop_shape)
        self.settings = dict(settings)

    def forward(self, images):
        return device_program(self.craft, self.crnn, self.crop_shape, images, **self.settings)


class ExportedPipeline:
    """Serving wrapper for a :meth:`Pipeline.export` artifact.

    Holds only the loaded program (a callable taking the (batch, height,
    width, 3) uint8 batch on ``meta["device"]``) and the host metadata, no
    model classes or weight files, and exposes the same ``recognize(images)
    -> [[(word, box)]]`` contract for its static (batch, height, width)
    envelope. The weights are those the pipeline had when it was exported:
    training its models afterwards changes the live ``Pipeline``, not the
    artifact (export again).
    """

    def __init__(self, program, meta: dict):
        self._program = program
        self.meta = meta
        self.alphabet = meta["alphabet"]
        self.device = torch.device(meta.get("device", "cpu"))

    def recognize(self, images, return_diagnostics: bool = False):
        """Serve one batch; optionally surface per-image health flags.

        With ``return_diagnostics=True`` returns ``(results, diags)`` where
        each diag dict reports where the static artifact may diverge from
        the live pipeline's escalation ladders (``Pipeline._fetch_escalating``):

        * ``n_components``: thresholded components the labelling found;
          components beyond the baked ``max_components`` were dropped in
          raster order.
        * ``converged``: the labelling converged within the baked sweeps.
        * ``refine_pending``: a multi-blob component's contours[0]
          refinement is beyond the baked ``refine_level``; its box may be a
          superset of the reference's.
        * ``warp_downscaled``: a word crop exceeded the warp window and took
          the antialiased downscale instead of the exact slice path.
        * ``truncated``: every word slot filled; the scene may hold more
          than ``max_words`` words.

        Artifacts whose packed rows lack the two diagnostic columns return
        ``None`` for the flag-derived fields.
        """
        height, width = self.meta["height"], self.meta["width"]
        batch_size = self.meta["batch_size"]
        if len(images) > batch_size:
            raise ValueError(f"artifact serves batches of {batch_size}, got {len(images)}")
        batch = np.zeros((batch_size, height, width, 3), dtype="uint8")
        for i, image in enumerate(images):
            image = tools.read(image)
            if image.shape[0] > height or image.shape[1] > width:
                raise ValueError(
                    f"image {image.shape} exceeds the exported envelope ({height}, {width})"
                )
            batch[i] = tools.pad(image, width=width, height=height)
        with torch.inference_mode():
            packed = self._program(torch.from_numpy(batch).to(self.device))
        packed = packed.cpu().numpy()[: len(images)]
        boxes = packed[..., :8].reshape(packed.shape[0], packed.shape[1], 4, 2)
        mask = packed[..., 8] > 0.5
        # Slice by the artifact's own CTC length: packed rows of 9+T columns
        # (no diagnostics) and of 9+T+1 or 9+T+2 all decode all T frames.
        ctc_time = self.meta["ctc_time"]
        decoded = packed[..., 9 : 9 + ctc_time].astype("int32")
        has_diag_columns = packed.shape[-1] >= 9 + ctc_time + 2
        results, diags = [], []
        for i in range(len(images)):
            valid = mask[i]
            words = ctc_ops.ctc_decode_to_strings(decoded[i][valid], self.alphabet)
            image_boxes = boxes[i][valid].astype("float32") / self.meta["scale"]
            results.append(list(zip(words, [box for box in image_boxes])))
            if return_diagnostics:
                diag = {
                    "truncated": bool(valid.all()) and valid.size > 0,
                    "n_components": None,
                    "converged": None,
                    "refine_pending": None,
                    "warp_downscaled": None,
                }
                if has_diag_columns:
                    flags = int(packed[i, 0, 9 + ctc_time + 1])
                    diag.update(
                        n_components=int(packed[i, 0, 9 + ctc_time]),
                        converged=bool(flags & 1),
                        refine_pending=bool(flags & 2),
                        warp_downscaled=bool(flags & 4),
                    )
                diags.append(diag)
        if return_diagnostics:
            return results, diags
        return results


def load_exported(path: str) -> ExportedPipeline:
    """Load a :meth:`Pipeline.export` artifact (``<path>.pt2`` and
    ``<path>.json``) into a serving-ready :class:`ExportedPipeline`. The op
    modules are imported first, so that the graph's kernel ops resolve."""
    from ..ops import cc_cuda, conv_cuda  # noqa: F401  (registers the ops)

    program = torch.export.load(path + ".pt2").module()
    with open(path + ".json") as f:
        meta = json.load(f)
    return ExportedPipeline(program, meta)
