"""Export the golden slim pipeline and time it: ``python3 scripts/export_golden.py --device cpu``.

For the standard and the BN-folded graph: ``Pipeline.export`` at the
artifact's ``pad_to`` envelope (batch 4), ``load_exported``, one served
batch of the first four golden scenes, whose packed output must equal the
live device program's at the baked levels. Prints per graph the export,
save and load seconds, the ``.pt2`` size and the graph's node count (the
same measurement as ``chip_smoke.py`` phase 10, which makes it on the card).
Artifacts are written under ``build/serving/`` and removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ARTIFACT, SERVING_DIR, export_summary, timed_export  # noqa: E402
from keras_ocr_tpu_torch import tools  # noqa: E402
from keras_ocr_tpu_torch.utils import golden  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    torch.set_num_threads(2)
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    try:
        for label, fold_bn in (("standard", False), ("folded", True)):
            pipeline, meta = golden.load_golden_pipeline(ARTIFACT, device=device, fold_bn=fold_bn)
            height, width = meta["pad_to"]
            path = os.path.join(SERVING_DIR, label)
            served, seconds = timed_export(pipeline, path, height=height, width=width,
                                           batch_size=4)
            images = [tools.pad(tools.read(os.path.join(ARTIFACT, f"scene_0{i}.png")),
                                width=width, height=height) for i in range(4)]
            batch = torch.from_numpy(np.stack(images)).to(device)
            with torch.inference_mode():
                packed = served._program(batch)
            live = pipeline._device_pipeline(
                batch, 0.7, 0.4, 0.4, 10.0, pipeline.detector.max_components,
                served.meta["max_words"], resize_to=(2 * height, 2 * width),
                refine_level=served.meta["refine_level"], warp_level=served.meta["warp_level"],
            )
            if not torch.equal(packed, live):
                raise AssertionError(f"{label}: the artifact's packed output differs from live")
            print(f"golden {label} on {device} (batch 4, {height}x{width}): "
                  f"{export_summary(served, path, seconds)}; packed output equal to live")
    finally:
        shutil.rmtree(SERVING_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
