"""Where the PyTorch port's device program spends its time, on one GPU.

Runs the stages of ``keras_ocr_tpu_torch.pipeline.Pipeline._device_pipeline``
one by one at full width (``Detector(width=1.0)``, the default
``Recognizer``, seeded random weights) on 640x480 images at scale 2, and
reports for batch 1 and batch 8:

* each stage's device time (CUDA events, median of 10 runs) and the host
  time to enqueue it (a stage whose host time exceeds its device time is
  launch-bound);
* the device busy time of ``get_boxes`` (a launch-bound stage, so its
  event time is its host time) and of the sweep kernel's passes in it,
  from ``torch.profiler``;
* the wall time of one ``Pipeline.recognize_many`` call on that batch and
  the device's busy share over it, from ``torch.profiler``, with the sweep
  kernel's share and the top kernels by device time.

Usage (on a machine with a card): ``python3 scripts/profile_torch_pipeline.py``;
the last line of its output is the whole result as JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, tools  # noqa: E402
from keras_ocr_tpu_torch.ops import ctc as ctc_ops  # noqa: E402
from keras_ocr_tpu_torch.ops import postprocess  # noqa: E402
from keras_ocr_tpu_torch.ops.image import (  # noqa: E402
    compute_input,
    resize_bilinear,
    rgb_to_grayscale,
)
from keras_ocr_tpu_torch.ops.warp import warp_boxes_batch  # noqa: E402

ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
REPS = 10


def timed(fn, reps=REPS):
    """(median device ms, median host enqueue ms, result) of ``fn``."""
    result = fn()
    torch.cuda.synchronize()
    device_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        result = fn()
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(stop))
    return statistics.median(device_ms), statistics.median(host_ms), result


@torch.inference_mode()
def stage_times(pipeline, images):
    """Device/host ms of each stage of the device program on one batch."""
    device_batch, _, _, resize_to = pipeline._prepare(images)
    out = {}

    def record(name, fn):
        dev, host, result = timed(fn)
        out[name] = {"device_ms": dev, "host_ms": host}
        return result

    x = record("upscale+normalize", lambda: compute_input(
        resize_bilinear(device_batch.to(torch.float32), *resize_to)))
    heatmaps = record("craft", lambda: pipeline.detector.model(x))
    boxes, mask, _ = record("get_boxes", lambda: postprocess.get_boxes(
        heatmaps, max_components=pipeline._component_cap))
    # A launch-bound stage's event time is its host time: its device work
    # comes from the profiler.
    kernels = device_kernels(lambda: postprocess.get_boxes(
        heatmaps, max_components=pipeline._component_cap))
    out["get_boxes"]["busy_ms"] = sum(ms for ms, _ in kernels.values())
    out["get_boxes"]["sweep_kernel_ms"] = sweep_ms(kernels)
    words = pipeline.word_buckets[0]

    def crops_fn():
        order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :words]
        boxes_c = torch.gather(boxes, 1, order[..., None, None].expand(-1, -1, 4, 2))
        source = torch.clamp(rgb_to_grayscale(
            resize_bilinear(device_batch.to(torch.float32), *resize_to)), 0, 255)
        return (warp_boxes_batch(source, boxes_c) / 255.0)[..., None]

    crops = record("compact+gray+warp", crops_fn)
    flat = crops.reshape((-1,) + crops.shape[2:])
    probs = record("crnn", lambda: pipeline.recognizer.model(flat))
    record("ctc", lambda: ctc_ops.ctc_greedy_decode(probs))
    return out


def device_kernels(fn):
    """{kernel name: (device ms, launches)} of one call of ``fn``, from
    ``torch.profiler`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for event in prof.key_averages():
        # Device-side events only: an aten op's "self" device time repeats
        # the time of the kernels it launched.
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us = event.self_device_time_total
        if device_us > 0:
            kernels[event.key] = (device_us / 1e3, event.count)
    return kernels


def sweep_ms(kernels):
    """(device ms, launches) of the sweep kernel's passes among ``kernels``."""
    parts = [v for name, v in kernels.items() if "sweep_pass" in name]
    return sum(ms for ms, _ in parts), sum(n for _, n in parts)


def profile_call(pipeline, images):
    """Wall ms of one recognize_many call and the profiler's view of it."""
    wall = []

    def call():
        start = time.perf_counter()
        pipeline.recognize_many(images, batch_size=len(images))
        wall.append((time.perf_counter() - start) * 1e3)

    kernels = device_kernels(call)
    wall_ms = wall[-1]
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "sweep_kernel_ms": sweep_ms(kernels),
        "top_kernels": [
            {"name": name[:90], "device_ms": ms, "count": count} for name, (ms, count) in top
        ],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    pipeline = Pipeline(
        detector=Detector(width=1.0, device=device, seed=0),
        recognizer=Recognizer(device=device, seed=1),
        scale=2,
    )
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        names = [entry["image"] for entry in json.load(f)["scenes"]]
    scenes = [
        tools.pad(tools.read(os.path.join(ARTIFACT, name)), width=640, height=480)
        for name in names
    ]
    result = {"card": card, "torch": torch.__version__, "batches": {}}
    for batch in (1, 8):
        images = scenes[:batch]
        stages = stage_times(pipeline, images)
        call = profile_call(pipeline, images)
        result["batches"][batch] = {"stages": stages, "recognize_many": call}
        print(f"batch {batch} ({card}):")
        for name, t in stages.items():
            print(f"  {name:18s} device {t['device_ms']:9.3f} ms  host {t['host_ms']:9.3f} ms")
        boxes = stages["get_boxes"]
        print(f"  get_boxes device busy {boxes['busy_ms']:.3f} ms, of it the sweep kernel "
              f"{boxes['sweep_kernel_ms'][0]:.3f} ms in {boxes['sweep_kernel_ms'][1]} launches")
        print(f"  one call: wall {call['wall_ms']:.2f} ms, device busy "
              f"{call['device_busy_ms']:.2f} ms ({100 * call['device_busy_share']:.1f}%), "
              f"the sweep kernel {call['sweep_kernel_ms'][0]:.3f} ms in "
              f"{call['sweep_kernel_ms'][1]} launches")
        for k in call["top_kernels"][:8]:
            print(f"    {k['device_ms']:9.3f} ms x{k['count']:5d}  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
