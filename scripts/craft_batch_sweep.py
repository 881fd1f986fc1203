"""Where the CRAFT forward leaves proportion to its batch:
``python3 scripts/craft_batch_sweep.py [--dtype float32|bfloat16]`` (one
CUDA card).

For the full-width VGG16-BN CRAFT and the EfficientNet-B0 CRAFT (random
weights, seeded BatchNorm statistics), at 960x1280 (a 640x480 image at
scale 2) and 512x640 (the golden artifact's ``pad_to`` envelope at scale
2), batches 1-8, in the model's ``compute_dtype`` (``--dtype``; float32
under ``full_float32``, TF32 off, or bfloat16 with float32 parameters,
where every conv runs on a bf16 input), it times with CUDA events (median
of ``--runs``):

- the whole forward three ways: ``nchw`` (the model as it is),
  ``channels_last`` (a copy whose weights are channels-last, so cuDNN runs
  every conv in its NHWC kernels) and ``split`` (one image at a time);
- every conv of the forward alone on its input of that batch: ``nchw``,
  ``nhwc`` (module and input channels-last), ``split`` (the batch in
  single images) and ``native`` (cuDNN off: PyTorch's own im2col GEMM);

then prints, per model and size, each batch's forward ms and ms per image
against batch 1's, and every (conv, batch) whose ``nchw`` time per image
exceeds twice its batch-1 time per image, with the other variants' times;
the kernels the profiler shows for ``upconv2.block1.conv`` at batch 2; and
the heatmaps of the ``channels_last`` and ``split`` forwards against the
``nchw`` forward of each image alone, as max|d| / max(1, max|ref|). The
whole table goes to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from keras_ocr_tpu_torch import Detector  # noqa: E402
from keras_ocr_tpu_torch.models.layers import full_float32  # noqa: E402

SIZES = ((960, 1280), (512, 640))
BATCHES = tuple(range(1, 9))
CL = torch.channels_last


def conv_inputs(model, x):
    """{conv name: (module, input shape at x's batch)} of one forward."""
    found, hooks = {}, []
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Conv2d):
            def record(module, args, name=name):
                found.setdefault(name, (module, tuple(args[0].shape)))

            hooks.append(module.register_forward_pre_hook(record))
    try:
        model(x)
    finally:
        for hook in hooks:
            hook.remove()
    return found


def conv_variants(module, x):
    """The four ways of one conv on ``x`` (NCHW contiguous)."""
    module_cl = copy.deepcopy(module).to(memory_format=CL)
    x_cl = x.contiguous(memory_format=CL)

    def native():
        with torch.backends.cudnn.flags(enabled=False):
            return module(x)

    return {
        "nchw": lambda: module(x),
        "nhwc": lambda: module_cl(x_cl),
        "split": lambda: torch.cat([module(x[i : i + 1]) for i in range(x.shape[0])]),
        "native": native,
    }


def kernels_of(fn, count=3):
    """(name, device ms) of the ``count`` kernels with the most device time
    in one call of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.device_time_total, reverse=True)
    return [(e.key[:80], round(e.device_time_total / 1e3, 3), e.count) for e in rows[:count]]


def relative(out, ref):
    return float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def sweep_model(label, model, runs, card, dtype):
    model_cl = copy.deepcopy(model).to(memory_format=CL)
    table = {}
    for height, width in SIZES:
        size = f"{height}x{width}"
        forward, convs = {}, {}
        gen = torch.Generator(device="cuda").manual_seed(height)
        inputs = torch.randn((max(BATCHES), height, width, 3), device="cuda", generator=gen)
        refs = torch.cat([model(inputs[i : i + 1]) for i in range(max(BATCHES))])
        layers = conv_inputs(model, inputs[:1])
        errors = {}
        for batch in BATCHES:
            x = inputs[:batch]
            ways = {
                "nchw": lambda: model(x),
                "channels_last": lambda: model_cl(x),
                "split": lambda: torch.cat([model(x[i : i + 1]) for i in range(batch)]),
            }
            forward[batch] = {way: chip_smoke.cuda_median_ms(fn, runs=runs)
                              for way, fn in ways.items()}
            errors[batch] = {way: relative(fn(), refs[:batch]) for way, fn in ways.items()}
            for name, (module, shape) in layers.items():
                xb = torch.randn((batch,) + shape[1:], device="cuda", generator=gen).to(dtype)
                convs[name, batch] = {
                    way: chip_smoke.cuda_median_ms(fn, runs=runs)
                    for way, fn in conv_variants(module, xb).items()}
            print(f"{label} {size} batch {batch}: forward " + ", ".join(
                f"{way} {ms:.3f} ms ({ms / batch:.3f} an image)"
                for way, ms in forward[batch].items())
                + "; heatmaps vs each image alone " + ", ".join(
                f"{way} {err:.3e}" for way, err in errors[batch].items()), flush=True)
        base = forward[1]["nchw"]
        print(f"{label} {size} ({card}): nchw ms per image / batch 1's: " + ", ".join(
            f"b{b} {forward[b]['nchw'] / b / base:.2f}" for b in BATCHES))
        slow = []
        for (name, batch), ways in sorted(convs.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            one = convs[name, 1]["nchw"]
            if ways["nchw"] / batch > 2 * one:
                slow.append((name, batch, ways, one))
                print(f"  slow conv {name} {tuple(layers[name][1][1:])} batch {batch}: " + ", ".join(
                    f"{way} {ms:.3f}" for way, ms in ways.items())
                    + f" ms; batch 1 nchw {one:.3f} ms")
        if not slow:
            print(f"  no conv of {label} at {size} exceeds 2x its batch-1 time per image")
        table[size] = {
            "forward_ms": {str(b): v for b, v in forward.items()},
            "heatmap_rel_err": {str(b): v for b, v in errors.items()},
            "conv_ms": {f"{name}@{batch}": v for (name, batch), v in convs.items()},
            "conv_shapes": {name: list(shape[1:]) for name, (_, shape) in layers.items()},
            "slow": [[name, batch] for name, batch, _, _ in slow],
        }
    return table


def main() -> int:
    if not torch.cuda.is_available():
        print("craft_batch_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--models", default="vgg,efficientnetb0")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--out", default=None,
                        help="JSON table (default build/craft_batch_sweep[_bfloat16].json)")
    args = parser.parse_args()
    if args.out is None:
        suffix = "" if args.dtype == "float32" else f"_{args.dtype}"
        args.out = os.path.join(ROOT, "build", f"craft_batch_sweep{suffix}.json")
    card = chip_smoke.card_line()
    dtype = getattr(torch, args.dtype)
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}; compute dtype {args.dtype}")
    device = torch.device("cuda")
    results = {"card": card, "torch": torch.__version__, "dtype": args.dtype}
    with torch.inference_mode(), full_float32():
        for name in args.models.split(","):
            if name == "vgg":
                model = Detector(weights=None, width=1.0, compute_dtype=dtype, device=device,
                                 seed=0).model
            else:
                model = chip_smoke.efficientnet_detector(name, device,
                                                         compute_dtype=dtype)[0].model
            chip_smoke.seed_batch_norm(model, seed=2)
            if name == "vgg":
                module = model.upconv2.block1.conv
                for batch in (1, 2, 8):
                    x = torch.randn((batch, 256, 120, 160), device="cuda").to(dtype)
                    for way, fn in conv_variants(module, x).items():
                        print(f"vgg upconv2.block1.conv batch {batch} {way}: kernels "
                              f"{kernels_of(fn)}", flush=True)
            results[name] = sweep_model(name, model, args.runs, card, dtype)
            del model
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf8") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {os.path.relpath(args.out, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
