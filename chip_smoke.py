"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing one line; any failure exits non-zero:

1. environment: the card (name, power limit), torch and CUDA versions, TF32
   off for convolutions and matrix products;
2. build: the CUDA sweep kernel from ``keras_ocr_tpu_torch/csrc``;
3. kernel vs plain: both entries of the sweep kernel (the label sweeps and
   the keyed row/column runs of the blob census) against their plain
   PyTorch versions on the card, on seeded masks (densities 0.3-0.8 plus a
   serpentine that needs more than 8 sweeps) at (4, 256, 320) and
   (8, 480, 640); maps and converged flags must be exactly equal; median
   times of 20 runs;
4. golden: the committed trained slim pipeline
   (``tests/fixtures/golden_offline``) must read at least the artifact's
   ``pass_fraction`` of its expected words;
5. full width: ``Detector(width=1.0)`` and the default ``Recognizer``
   (filters 64..512, STN) on seeded random weights, ``Pipeline(scale=2)``
   on the golden scenes padded to 640x480, through ``recognize`` and
   ``recognize_many(batch_size=8)``; the output must be well formed with
   finite boxes, the device program must enqueue without a host
   synchronisation, and the pipeline phases must have launched both kernel
   entries.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. There is no CPU path.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SHAPES = ((4, 256, 320), (8, 480, 640))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def serpentine(height, width):
    """A snake with a bend every two rows: far more than 8 sweeps."""
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def cuda_median_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sweep_inputs(batch, height, width):
    """Seeded masks of density 0.3-0.8, the last one a serpentine, as
    label-propagation inputs."""
    rng = np.random.RandomState(batch)
    fg = np.stack([rng.rand(height, width) < d for d in np.linspace(0.3, 0.8, batch)])
    fg[-1] = serpentine(height, width)
    sentinel = height * width
    idx = np.arange(sentinel, dtype=np.int32).reshape(height, width)
    values = torch.from_numpy(np.where(fg, idx, sentinel).astype(np.int32)).cuda()
    return fg, values, sentinel


def keyed_inputs(batch, height, width):
    """Seeded dilated-blob covers with blocky component keys."""
    fg, values, sentinel = sweep_inputs(batch, height, width)
    yy, xx = np.mgrid[0:height, 0:width]
    key = np.broadcast_to((yy // 24 * 7 + xx // 40) % 5, fg.shape).astype(np.int32)
    key = np.where(fg, key, -1)
    return values, torch.from_numpy(key).cuda(), torch.from_numpy(fg).cuda(), sentinel


def kernel_phase(cc_cuda):
    """Exact comparison and timing of the two launch entries of the sweep
    kernel against their plain versions; returns, per kernel, the largest
    difference and the (8, 480, 640) times."""
    report = {"cc_sweeps": [0, None], "cc_keyed_rows_cols": [0, None]}
    for batch, height, width in SHAPES:
        fg, values, sentinel = sweep_inputs(batch, height, width)
        barrier = torch.from_numpy((~fg).astype(np.int32)).cuda()
        for sweeps in (1, 8):
            out, conv = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True)
            ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(
                values, barrier, sentinel, sweeps, True
            )
            torch.cuda.synchronize()
            diff = int((out.to(torch.int64) - ref).abs().max())
            report["cc_sweeps"][0] = max(report["cc_sweeps"][0], diff)
            if diff or not torch.equal(conv, ref_conv):
                raise AssertionError(
                    f"sweep kernel disagrees at {(batch, height, width)}, {sweeps} "
                    f"sweeps: max diff {diff}, converged {conv.tolist()} vs "
                    f"{ref_conv.tolist()}"
                )
        if bool(ref_conv[-1]):
            raise AssertionError("the serpentine mask converged at 8 sweeps")
        ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, 8, True)
        )
        plain_ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, 8, True)
        )
        report["cc_sweeps"][1] = (ms, plain_ms)
        print(
            f"kernel vs plain: cc_sweeps {(batch, height, width)} exact, converged "
            f"{conv.tolist()}, 8 sweeps + check: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median of 20)"
        )
        keyed = keyed_inputs(batch, height, width)
        out = cc_cuda.keyed_rows_cols(*keyed)
        ref = cc_cuda.keyed_rows_cols_plain(*keyed)
        torch.cuda.synchronize()
        diff = int((out.to(torch.int64) - ref).abs().max())
        report["cc_keyed_rows_cols"][0] = max(report["cc_keyed_rows_cols"][0], diff)
        if diff:
            raise AssertionError(f"keyed kernel disagrees at {(batch, height, width)}: {diff}")
        ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols(*keyed))
        plain_ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols_plain(*keyed))
        report["cc_keyed_rows_cols"][1] = (ms, plain_ms)
        print(
            f"kernel vs plain: cc_keyed_rows_cols {(batch, height, width)} exact, "
            f"one row + column pass: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            "(median of 20)"
        )
    return report


def check_results(results, count):
    if len(results) != count:
        raise AssertionError(f"{len(results)} results for {count} images")
    for words in results:
        for word, box in words:
            if not isinstance(word, str) or box.shape != (4, 2) or not np.isfinite(box).all():
                raise AssertionError(f"malformed result ({word!r}, {box})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, kernels, tools
    from keras_ocr_tpu_torch.ops import cc_cuda
    from keras_ocr_tpu_torch.utils import golden

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"environment: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    start = time.perf_counter()
    kernels.load(cc_cuda.SOURCE)
    print(f"build: {cc_cuda.SOURCE} in {time.perf_counter() - start:.2f} s")

    report = kernel_phase(cc_cuda)
    wrappers = {
        "cc_sweeps": cc_cuda.segmented_min_sweeps,
        "cc_keyed_rows_cols": cc_cuda.keyed_rows_cols,
    }

    # The main path, from here to the end: count its kernel launches.
    for wrapper in wrappers.values():
        wrapper.launches = 0
    result = golden.run_golden_check(ARTIFACT, device=device)
    with open(os.path.join(ARTIFACT, "meta.json"), encoding="utf8") as f:
        pass_fraction = json.load(f)["pass_fraction"]
    print(f"golden: fraction {result['fraction']} over {result['n_words']} words / "
          f"{result['n_scenes']} scenes (pass >= {pass_fraction}); last_run_stats "
          f"{result['run_stats']}")
    if not result["pass"]:
        raise AssertionError(f"golden check failed: {result}")

    detector = Detector(width=1.0, device=device, seed=0)
    recognizer = Recognizer(device=device, seed=1)
    pipeline = Pipeline(detector=detector, recognizer=recognizer, scale=2)
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        names = [entry["image"] for entry in json.load(f)["scenes"]]
    scenes = [
        tools.pad(tools.read(os.path.join(ARTIFACT, name)), width=640, height=480)
        for name in names
    ]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        check_results(pipeline.recognize([scenes[0]]), 1)
    # The device program must not make the host wait: only the fetch does.
    device_batch, _, _, resize_to = pipeline._prepare(scenes[:8])
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the debug mode's "prototype" notice
        torch.cuda.set_sync_debug_mode("error")
        try:
            pipeline._launch(
                device_batch, {}, pipeline.word_buckets[0], resize_to,
                pipeline._component_cap, pipeline._num_sweeps,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    latencies = []
    for image in scenes[:10]:
        start = time.perf_counter()
        results = pipeline.recognize([image])
        latencies.append((time.perf_counter() - start) * 1e3)
        check_results(results, 1)
    many = (scenes * 3)[:32]
    check_results(pipeline.recognize_many(many, batch_size=8), len(many))
    start = time.perf_counter()
    results = pipeline.recognize_many(many, batch_size=8)
    images_per_s = len(many) / (time.perf_counter() - start)
    check_results(results, len(many))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    p50 = statistics.median(latencies)
    print(f"full width ({card}): device program of 8 images enqueued with no host "
          f"synchronisation (torch.cuda sync debug mode 'error'); recognize p50 "
          f"{p50:.2f} ms (640x480, scale 2, 10 images), recognize_many {images_per_s:.2f} images/s "
          f"(32 images, batch 8), peak memory {peak_gb:.3f} GB; last_run_stats "
          f"{pipeline.last_run_stats}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    replaces = {
        "cc_sweeps": "keras_ocr_tpu/ops/cc_pallas.py:82",
        # An XLA loop in the JAX package, not a Pallas kernel.
        "cc_keyed_rows_cols": "keras_ocr_tpu/ops/cc.py:210",
    }
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "keras_ocr_tpu_torch/csrc/cc_sweeps.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": report[name][0],
            "ms": report[name][1][0],
            "plain_ms": report[name][1][1],
        }
        for name in wrappers
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
