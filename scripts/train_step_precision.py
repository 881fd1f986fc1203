"""How far one train step's gradients sit from the float64 ones, on the card
and on the CPU: ``python3 scripts/train_step_precision.py`` (one CUDA card).

For the full-width CRNN (dropout 0; STN off and at its identity start) at
batch 8 and CRAFT (width 1.0) at 2x256x256 (``chip_smoke.py`` phase 11's
batches), from one seeded state, each
variant's gradient leaves are compared with the float64 CPU step's (max
|g - g64| over the leaf's max |g64|): the float32 CPU step, the float32
card step with cuDNN on and off, and the float64 card step. For the CRNN
it also prints each layer's forward error. TF32 is off throughout.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from keras_ocr_tpu_torch import Detector, Recognizer, weights  # noqa: E402
from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS  # noqa: E402
from keras_ocr_tpu_torch.ops.ctc import ctc_loss  # noqa: E402
from keras_ocr_tpu_torch.train.detector import _mse_loss  # noqa: E402

CRNN_LAYERS = ("conv_1", "conv_3", "bn_3", "conv_5", "bn_5", "conv_7", "bn_7", "fc_9",
               "lstm_10", "lstm_11", "fc_12")


def summary(model, reference, bridge):
    """Leaves over 1e-3 and the three worst, against the reference; leaves
    that are rounding noise in the reference (zero in exact arithmetic)
    are left out."""
    errors, _ = chip_smoke.gradient_errors(model, reference, bridge)
    rows = sorted(((e, k) for k, e in errors.items()), reverse=True)
    return (f"{sum(e > 1e-3 for e, _ in rows)}/{len(rows)} leaves over 1e-3, worst "
            + "; ".join(f"{k} {e:.2e}" for e, k in rows[:3]))


def crnn_step(recognizer, batch, activations=None):
    (x, labels, input_length, label_length), _ = batch
    model = recognizer.model.train()
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    hooks = []
    if activations is not None:
        for name in CRNN_LAYERS:
            def keep(module, args, out, name=name):
                out = out[0] if isinstance(out, tuple) else out
                activations[name] = out.detach().to("cpu", torch.float64)
            hooks.append(getattr(model, name).register_forward_hook(keep))
    logits = model(torch.from_numpy(x).to(device, dtype), return_logits=True)
    for hook in hooks:
        hook.remove()
    ctc_loss(logits, torch.from_numpy(labels).to(device),
             torch.as_tensor(input_length, device=device).long().reshape(-1),
             torch.as_tensor(label_length, device=device).reshape(-1)).mean().backward()
    model.eval()
    return model


def craft_step(detector, images, targets):
    model = detector.model.train()
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    preds = model(torch.from_numpy(images).to(device, dtype))
    _mse_loss(preds, torch.from_numpy(targets).to(device, dtype),
              torch.ones(len(images), device=device, dtype=dtype)).backward()
    model.eval()
    return model


# (label, device, dtype, cuDNN on) of each variant held to the float64 CPU step.
VARIANTS = (
    ("CPU float32", "cpu", torch.float32, True),
    ("card float32", "cuda", torch.float32, True),
    ("card float32, cuDNN off", "cuda", torch.float32, False),
    ("card float64", "cuda", torch.float64, True),
)


def fresh(make, variables, on, dtype):
    built = make(on).load_variables(variables)
    built.model.to(dtype)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_precision: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{chip_smoke.card_line()}; torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    rng = np.random.RandomState(11)
    batch = chip_smoke.crnn_batch(rng, 8, 48, 36)
    for stn in (False, True):
        params = dict(DEFAULT_BUILD_PARAMS, dropout=0.0, stn=stn)

        def make(on, params=params):
            return Recognizer(build_params=params, device=on, seed=3)

        variables = weights.crnn_variables(make("cpu").model)
        wide_acts: dict = {}
        reference = crnn_step(fresh(make, variables, "cpu", torch.float64), batch, wide_acts)
        for label, on, dtype, cudnn in VARIANTS:
            acts: dict = {}
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                model = crnn_step(fresh(make, variables, on, dtype), batch, acts)
            forward = ", ".join(
                f"{n} {float((acts[n] - wide_acts[n]).abs().max() / wide_acts[n].abs().max()):.1e}"
                for n in CRNN_LAYERS)
            print(f"CRNN batch 8, STN {'on' if stn else 'off'}, {label}: gradients "
                  f"{summary(model, reference, weights.crnn_variables)}; forward error by "
                  f"layer {forward}")

    images, targets = chip_smoke.craft_batch(rng, 2, 256, 256)

    def make_detector(on):
        return Detector(width=1.0, device=on, seed=4)

    variables = weights.craft_variables(make_detector("cpu").model)
    reference = craft_step(fresh(make_detector, variables, "cpu", torch.float64), images, targets)
    for label, on, dtype, cudnn in VARIANTS:
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            model = craft_step(fresh(make_detector, variables, on, dtype), images, targets)
        print(f"CRAFT width 1.0, 2x256x256, {label}: gradients "
              f"{summary(model, reference, weights.craft_variables)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
