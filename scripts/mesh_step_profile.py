"""Where does a train step on a mesh spend its time? ``python3
scripts/mesh_step_profile.py`` (one card).

One full-width train step (CRNN at batch 8, dropout 0; or CRAFT at
640x640, batch 8, with ``--model craft``) without a mesh, on a one-device
mesh (``parallel.create_mesh()``) and on two replicas of the card, each
timed by CUDA events (median of 5 after a warm-up), its training-mode
forward alone timed the same way, and the step profiled once with
``torch.profiler``: the step's wall ms, the device's busy ms and the ops
whose host or device time differs most between the variants.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, craft_batch, crnn_batch  # noqa: E402
from keras_ocr_tpu_torch import Detector, Recognizer, parallel  # noqa: E402
from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS  # noqa: E402
from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer  # noqa: E402
from keras_ocr_tpu_torch.train.recognizer import sharded_forward  # noqa: E402


def step_ms(step, runs=5):
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def profile(step):
    """(wall ms, device busy ms, {op: (host ms, device ms, calls)}) of one step."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    ops, busy = {}, 0.0
    for event in prof.key_averages():
        device_ms = event.self_device_time_total / 1e3
        if event.device_type == torch.autograd.DeviceType.CUDA:
            busy += device_ms
        ops[event.key] = (event.self_cpu_time_total / 1e3, device_ms, event.count)
    return wall, busy, ops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("crnn", "craft"), default="crnn")
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mesh_step_profile: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(16)
    if args.model == "crnn":
        facade = Recognizer(weights=None, build_params=dict(DEFAULT_BUILD_PARAMS, dropout=0.0),
                            device=device, seed=16)
        trainer_cls, batch = RecognizerTrainer, crnn_batch(rng, 8, 48, 36)
    else:
        facade = Detector(weights=None, width=1.0, device=device, seed=17)
        trainer_cls, batch = DetectorTrainer, craft_batch(rng, 8, 640, 640)
    variants = {"no mesh": None, "one-device mesh": parallel.create_mesh(),
                "two replicas": parallel.create_mesh(devices=[device, device])}
    images = torch.as_tensor(batch[0][0] if args.model == "crnn" else batch[0], device=device)
    kwargs = {"return_logits": True} if args.model == "crnn" else {}
    results = {}
    for label, mesh in variants.items():
        trainer = trainer_cls(facade, mesh=mesh)
        ms = step_ms(lambda: trainer.train_step(batch))
        facade.model.train()
        if mesh is None:
            forward_ms = step_ms(lambda: facade.model(images, **kwargs))
        else:
            shards = [dict(kwargs) for _ in trainer.parallel.devices]
            forward_ms = step_ms(lambda: sharded_forward(trainer.parallel, images, device,
                                                         shards))
        facade.model.eval()
        results[label] = (ms, forward_ms, *profile(lambda: trainer.train_step(batch)))
    card = card_line()
    for label, (ms, forward_ms, wall, busy, _) in results.items():
        print(f"{args.model} step ({card}), {label}: {ms:.3f} ms, forward alone "
              f"{forward_ms:.3f} ms (CUDA events, median of 5); profiled: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms")
    base = results["no mesh"][4]
    for label in list(variants)[1:]:
        ops = results[label][4]
        keys = set(ops) | set(base)

        def delta(key, i):
            return ops.get(key, (0.0, 0.0, 0))[i] - base.get(key, (0.0, 0.0, 0))[i]

        for i, what in ((0, "host"), (1, "device")):
            top = sorted(keys, key=lambda k: -abs(delta(k, i)))[: args.top]
            print(f"{args.model}, {label} minus no mesh, {what} ms by op: " + "; ".join(
                f"{k[:60]} {delta(k, i):+.3f} ({ops.get(k, (0, 0, 0))[2]} calls)" for k in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
