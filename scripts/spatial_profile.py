"""Where does a CRAFT forward on row strips spend its time? ``python3
scripts/spatial_profile.py`` (one card).

The full-width CRAFT (seeded BatchNorm statistics) at 960x1280, in the
graphs ``--graph`` names (standard float32, folded float32, folded bf16,
and the EfficientNet-B0 CRAFT in float32 and bf16), without strips and
on the strips of one data position of 2 and 4 devices of the one card
(``parallel/halo.py``, as ``Pipeline(mesh=...)`` runs it):
each forward's CUDA-event ms (median of ``--runs``), its host ms until
the last launch is enqueued, and one call profiled with
``torch.profiler``: the device's busy ms, the kernels launched and the
kernels whose device time grows most against no strips. On strips also
the baton's hand-overs of one call (:class:`..parallel.halo.StripGroup`):
how many, and how long the woken strip's thread took to resume.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (card_line, cuda_median_ms, efficientnet_detector,  # noqa: E402
                        seed_batch_norm)
from keras_ocr_tpu_torch import Detector  # noqa: E402
from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict  # noqa: E402
from keras_ocr_tpu_torch.parallel.halo import StripForward, StripGroup  # noqa: E402

GRAPHS = ("standard", "folded", "folded-bf16", "b0", "b0-bf16")


def profile(fn):
    """(device busy ms, kernels launched, {kernel: device ms}) of one call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, count, kernels = 0.0, 0, {}
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3
        busy += ms
        count += event.count
        kernels[event.key] = kernels.get(event.key, 0.0) + ms
    return busy, count, kernels


def baton_waits(fn):
    """Seconds from each hand-over of the baton in one call to the moment
    the woken strip's thread resumes."""
    handed, waits = [0.0], []
    hand, wait = StripGroup._pass, StripGroup._wait

    def timed_hand(group, rank):
        handed[0] = time.perf_counter()
        hand(group, rank)

    def timed_wait(group, rank):
        wait(group, rank)
        waits.append(time.perf_counter() - handed[0])

    StripGroup._pass, StripGroup._wait = timed_hand, timed_wait
    try:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    finally:
        StripGroup._pass, StripGroup._wait = hand, wait
    return waits


def enqueue_ms(fn):
    """Host ms of one call, up to its return (the device still running)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    return ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--graph", choices=GRAPHS, nargs="+", default=list(GRAPHS))
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--top", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("spatial_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    device = torch.device("cuda", torch.cuda.current_device())
    standard = Detector(weights=None, width=1.0, device=device, seed=0)
    seed_batch_norm(standard.model, seed=2)
    models = {"standard": standard.model}
    for name, dtype in (("folded", torch.float32), ("folded-bf16", torch.bfloat16)):
        folded = Detector(weights=None, width=1.0, fold_bn=True, compute_dtype=dtype,
                          device=device)
        folded.model.load_state_dict(fold_bn_state_dict(standard.model.state_dict()))
        models[name] = folded.model
    b0, warned = efficientnet_detector("efficientnetb0", device)
    if warned:
        seed_batch_norm(b0.model, seed=2)
    b0_bf16, _ = efficientnet_detector("efficientnetb0", device, compute_dtype=torch.bfloat16)
    b0_bf16.model.load_state_dict(b0.model.state_dict())
    models.update({"b0": b0.model, "b0-bf16": b0_bf16.model})
    strips = {parts: StripForward([device] * parts) for parts in (2, 4)}
    with torch.inference_mode():
        for graph in args.graph:
            model = models[graph]
            for batch in args.batch:
                x = torch.randn((batch, 960, 1280, 3), device=device,
                                generator=torch.Generator(device=device).manual_seed(batch))
                variants = {"no strips": lambda: model(x)}
                for parts, forward in strips.items():
                    variants[f"{parts} strips"] = (
                        lambda forward=forward, parts=parts: forward([model] * parts, x))
                base = None
                for label, fn in variants.items():
                    ms = cuda_median_ms(fn, runs=args.runs)
                    host = enqueue_ms(fn)
                    busy, count, kernels = profile(fn)
                    base = base or kernels
                    grown = sorted(kernels, key=lambda k: -(kernels[k] - base.get(k, 0.0)))
                    waits = baton_waits(fn)
                    batons = "" if not waits else (
                        f", {len(waits)} baton hand-overs waited {sum(waits) * 1e3:.3f} ms "
                        f"(median {statistics.median(waits) * 1e6:.1f} us, max "
                        f"{max(waits) * 1e6:.1f} us)")
                    print(f"spatial forward ({card}): {graph}, batch {batch}, {label}: "
                          f"{ms:.3f} ms (CUDA events, median of {args.runs}), host enqueue "
                          f"{host:.3f} ms{batons}, device busy {busy:.3f} ms in {count} "
                          f"kernels; grown most against no strips: " + "; ".join(
                              f"{k[:70]} {kernels[k]:.3f} ms ({kernels[k] - base.get(k, 0.0):+.3f})"
                              for k in grown[: args.top]), flush=True)
                del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
