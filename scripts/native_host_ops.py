"""Could the native host ops stand in for the two-stage path's host resize
and crops? ``python3 scripts/native_host_ops.py`` (host only, no card).

The two-stage path (``Pipeline.recognize(..., recognition_kwargs=...)``)
resizes each image on the host with ``tools.resize_image`` (cv2
INTER_LINEAR in float64) and cuts each word with ``tools.warpBox``
(scipy's ``map_coordinates`` rule in float64). This script times both
against ``native.resize_bilinear`` and ``native.warp_perspective`` (float32
/ float64 C++) on the golden scenes padded to 640x480 at scale 2, the
two-stage phase's shapes in ``chip_smoke.py``, with the word boxes the
golden pipeline finds, and prints the largest difference in uint8 counts
and the share of values that differ. Nothing is switched: the JAX package
does not use its library there either.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from keras_ocr_tpu_torch import native, tools  # noqa: E402
from keras_ocr_tpu_torch.recognition import rgb_to_grayscale_host  # noqa: E402
from keras_ocr_tpu_torch.utils import golden  # noqa: E402

ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "golden_offline")


def best_ms(fn, runs=3):
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times), out


def native_warp_box(image, box, target_height, target_width):
    """``tools.warpBox`` with its perspective warp done by the library."""
    box, _ = tools.get_rotated_box(np.asarray(box, dtype="float32"))
    w, h = tools.get_rotated_width_height(box)
    scale = min(target_width / w, target_height / h)
    dst = np.array([[0, 0], [scale * w, 0], [scale * w, scale * h], [0, scale * h]], "float32")
    M = tools.get_perspective_transform(src=box, dst=dst)
    crop = native.warp_perspective(image, M, dsize=(int(scale * w), int(scale * h)))
    full = np.zeros((target_height, target_width) + image.shape[2:], dtype="uint8")
    full[: crop.shape[0], : crop.shape[1]] = crop
    return full


def difference(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(diff.max()), float((diff > 0).mean())


def main() -> int:
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    if not native.available():
        print("native_host_ops: the library did not build", file=sys.stderr)
        return 1
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        names = [entry["image"] for entry in json.load(f)["scenes"]]
    originals = [tools.read(os.path.join(ARTIFACT, name)) for name in names]
    pipeline = golden.load_golden_pipeline(ARTIFACT, device="cpu")[0]
    found = pipeline.recognize(originals)
    scenes = [tools.pad(image, width=640, height=480) for image in originals]

    resize = {"tools": [], "native": []}
    crops = {"tools": [], "native": []}
    worst, shares, crop_worst, crop_shares, n_crops = 0, [], 0, [], 0
    for scene, words in zip(scenes, found):
        ms, ref = best_ms(lambda: tools.resize_image(scene, max_scale=2, max_size=2048)[0])
        resize["tools"].append(ms)
        ms, out = best_ms(lambda: native.resize_bilinear(scene, *ref.shape[:2]))
        resize["native"].append(ms)
        top, share = difference(out, ref)
        worst, shares = max(worst, top), shares + [share]
        gray = rgb_to_grayscale_host(ref)
        boxes = [2 * box for _, box in words]
        ms, ref_crops = best_ms(lambda: [tools.warpBox(gray, b, 31, 200) for b in boxes])
        crops["tools"].append(ms)
        ms, out_crops = best_ms(lambda: [native_warp_box(gray, b, 31, 200) for b in boxes])
        crops["native"].append(ms)
        for a, b in zip(out_crops, ref_crops):
            top, share = difference(a, b)
            crop_worst, crop_shares = max(crop_worst, top), crop_shares + [share]
        n_crops += len(boxes)
    cpu = platform_line()
    print(f"native host ops ({cpu}): resize of {len(scenes)} scenes 640x480 -> 1280x960, ms per "
          f"image median [range]: tools.resize_image {statistics.median(resize['tools']):.2f} "
          f"[{min(resize['tools']):.2f}-{max(resize['tools']):.2f}], native.resize_bilinear "
          f"{statistics.median(resize['native']):.2f} [{min(resize['native']):.2f}-"
          f"{max(resize['native']):.2f}]; max difference {worst} uint8 counts, "
          f"{100 * float(np.mean(shares)):.3f}% of values differ")
    print(f"native host ops ({cpu}): {n_crops} word crops (31x200, grayscale, boxes of the "
          f"golden pipeline x2), ms per scene median [range]: tools.warpBox "
          f"{statistics.median(crops['tools']):.2f} [{min(crops['tools']):.2f}-"
          f"{max(crops['tools']):.2f}], native.warp_perspective "
          f"{statistics.median(crops['native']):.2f} [{min(crops['native']):.2f}-"
          f"{max(crops['native']):.2f}]; max difference {crop_worst} uint8 counts, "
          f"{100 * float(np.mean(crop_shares)):.3f}% of values differ")
    return 0


def platform_line() -> str:
    """The host's CPU model and core count."""
    try:
        with open("/proc/cpuinfo", encoding="utf8") as f:
            model = next(line.split(":", 1)[1].strip() for line in f
                         if line.startswith("model name"))
    except (OSError, StopIteration):
        model = "unknown CPU"
    return f"{model}, {os.cpu_count()} cores"


if __name__ == "__main__":
    sys.exit(main())
