"""The EfficientNet-B0 pipeline's first ``recognize`` in many fresh
processes: ``python3 scripts/first_recognize_repeat.py [--runs 30]
[--poisoned 10]`` (one CUDA card).

Each child process builds (or finds built) the sweep kernel, makes
``Detector(weights=None, backbone_name="efficientnetb0")`` with the network
refused (seeded BatchNorm statistics), the default ``Recognizer`` and
``Pipeline(scale=2)``, and calls ``recognize`` once on a golden scene
padded to 640x480, then once on 8 of them; it checks that the results are
well formed and that both sweep-kernel entries launched. The last
``--poisoned`` children also fill every int32 tensor that
``torch.empty_like`` makes on the card with a poison value, so that a
kernel output cell left unwritten would reach ``component_analysis`` as an
out-of-range label. The parent prints each child's exit code and, for a
failure, the end of its error output; the counts go to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POISON = -1_234_567_891


def child(poisoned: bool) -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from keras_ocr_tpu_torch import Pipeline, Recognizer, tools
    from keras_ocr_tpu_torch.ops import cc_cuda

    if poisoned:
        empty_like = torch.empty_like

        def poisoned_empty_like(tensor, *args, **kwargs):
            out = empty_like(tensor, *args, **kwargs)
            if out.is_cuda and out.dtype == torch.int32:
                out.fill_(POISON)
            return out

        torch.empty_like = poisoned_empty_like
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    with open(os.path.join(chip_smoke.ARTIFACT, "expected.json"), encoding="utf8") as f:
        names = [entry["image"] for entry in json.load(f)["scenes"]][:8]
    scenes = [tools.pad(tools.read(os.path.join(chip_smoke.ARTIFACT, name)), width=640,
                        height=480) for name in names]
    detector, warned = chip_smoke.efficientnet_detector("efficientnetb0", device)
    if warned:
        chip_smoke.seed_batch_norm(detector.model, seed=2)
    pipeline = Pipeline(detector=detector, recognizer=Recognizer(weights=None, device=device,
                                                                seed=1), scale=2)
    first = pipeline.recognize([scenes[0]])
    chip_smoke.check_results(first, 1)
    chip_smoke.check_results(pipeline.recognize(scenes), len(scenes))
    torch.cuda.synchronize()
    launches = (cc_cuda.segmented_min_sweeps.launches, cc_cuda.keyed_rows_cols.launches)
    if min(launches) <= 0:
        raise AssertionError(f"a sweep-kernel entry was never launched: {launches}")
    print(json.dumps({"words": len(first[0]), "launches": launches,
                      "boxes_finite": bool(all(np.isfinite(b).all() for _, b in first[0]))}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=30)
    parser.add_argument("--poisoned", type=int, default=10)
    parser.add_argument("--child", choices=("plain", "poisoned"))
    parser.add_argument("--timeout", type=float, default=180)
    parser.add_argument("--out", default=os.path.join(ROOT, "build",
                                                      "first_recognize_repeat.json"))
    args = parser.parse_args()
    if args.child:
        return child(args.child == "poisoned")
    import torch

    if not torch.cuda.is_available():
        print("first_recognize_repeat: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    runs = []
    for index in range(args.runs + args.poisoned):
        kind = "plain" if index < args.runs else "poisoned"
        start = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", kind],
                                  capture_output=True, text=True, timeout=args.timeout,
                                  cwd=ROOT)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as exc:
            rc, out, err = "timeout", exc.stdout or "", exc.stderr or ""
            out, err = (s.decode() if isinstance(s, bytes) else s for s in (out, err))
        seconds = time.perf_counter() - start
        last = out.strip().splitlines()[-1] if out.strip() else ""
        runs.append({"kind": kind, "rc": rc, "seconds": round(seconds, 2), "result": last,
                     "stderr_tail": err[-2000:] if rc != 0 else ""})
        print(f"process {index + 1} ({kind}): rc {rc} in {seconds:.1f} s; {last}"
              + (f"\n{err[-2000:]}" if rc != 0 else ""), flush=True)
    failed = {kind: sum(r["rc"] != 0 for r in runs if r["kind"] == kind)
              for kind in ("plain", "poisoned")}
    print(f"first recognize ({card}): {args.runs} plain and {args.poisoned} poisoned fresh "
          f"processes, failures {failed}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf8") as f:
        json.dump({"card": card, "failed": failed, "runs": runs}, f, indent=1)
    return 1 if sum(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
