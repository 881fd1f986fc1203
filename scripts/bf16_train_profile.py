"""Where a train step's device time goes, float32 against bfloat16, on one
card: ``python3 scripts/bf16_train_profile.py [--top N]``.

For the full-width CRNN at batch 8 (dropout 0.25, as trained) and the VGG
CRAFT at 640x640 batch 8 (the sizes of ``chip_smoke.py`` phase 17), built
with ``compute_dtype`` float32 and bfloat16, it runs three warm-up steps,
then records three steps with ``torch.profiler`` and prints, per model and
dtype, the step ms (CUDA events, median of the three), the device time per
step (the sum of its kernels) and the ``--top`` kernels by device time per
step with their share. Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def batches(rng):
    frames = 48
    label_length = rng.randint(1, 21, size=(8, 1))
    labels = np.full((8, frames), -1)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, 36, size=n)
    crnn = ((rng.rand(8, 31, 200, 1).astype(np.float32), labels, np.full((8, 1), frames),
             label_length), np.zeros((8, 1)))
    images = rng.randn(8, 640, 640, 3).astype(np.float32)
    targets = (rng.rand(8, 320, 320, 2) * 0.05).astype(np.float32)
    targets[:, 40:80, 20:200, 0] = 0.9
    return {"CRNN batch 8": crnn, "VGG CRAFT 640x640 batch 8": (images, targets)}


def profile_steps(trainer, batch, top):
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    times = []
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(3):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(batch)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
    kernels = sorted(((e.key[:90], e.self_device_time_total / 1e3 / 3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    return statistics.median(times), busy, kernels[:top]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bf16_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from keras_ocr_tpu_torch import Detector, Recognizer
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    card = card_line()
    device = torch.device("cuda")
    data = batches(np.random.RandomState(0))
    for label, batch in data.items():
        for dtype in (torch.float32, torch.bfloat16):
            if label.startswith("CRNN"):
                trainer = RecognizerTrainer(Recognizer(None, None, None, dtype, device=device,
                                                       seed=6))
            else:
                trainer = DetectorTrainer(Detector(weights=None, compute_dtype=dtype,
                                                   device=device, seed=4))
            step_ms, busy, kernels = profile_steps(trainer, batch, args.top)
            print(f"{label}, {str(dtype).replace('torch.', '')} ({card}): step {step_ms:.3f} ms "
                  f"(median of 3), device time {busy:.3f} ms a step; top kernels by device "
                  "time a step: " + "; ".join(
                      f"{name} {ms:.3f} ms ({ms / busy:.1%})" for name, ms in kernels), flush=True)
            del trainer
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
