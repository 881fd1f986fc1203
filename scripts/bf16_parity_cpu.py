"""The bfloat16 port's distance from the JAX package's bfloat16 on the CPU:
``JAX_PLATFORMS=cpu python scripts/bf16_parity_cpu.py [--pipeline]``
(needs both packages).

Prints, for the inputs and weights of ``tests/test_torch_bf16.py`` and
``tests/test_torch_bf16_crnn.py``:

- CRAFT (VGG: golden slim and the JAX init at (2, 64, 96) and (1, 72, 104);
  BN-folded; EfficientNet-B0 at (1, 64, 64)): max and mean |port - JAX|,
  the JAX module applied op by op, and the port beside the floors that
  bound any port: the JAX module jitted against itself op by op, the port
  with float64 sums against itself with float32 sums, JAX's bf16 against
  its float32, and a naive ``model.to(torch.bfloat16)``;
- the CRNN (golden; production filters with a non-identity STN): max and
  mean of the softmax, the frames whose argmax differs and how many of
  them are near ties (JAX's top two within 1e-2), for the port's
  ``nn.LSTM`` and for the JAX rounding step by step;
- with ``--pipeline``: the golden artifact's 12 scenes through both
  bfloat16 pipelines (standard and folded), the scenes whose words differ.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from keras_ocr_tpu.detection import Detector as JaxDetector  # noqa: E402
from keras_ocr_tpu.models.craft import CRAFT as JaxCRAFT  # noqa: E402
from keras_ocr_tpu.models.craft import fold_bn_variables  # noqa: E402
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer  # noqa: E402
from keras_ocr_tpu.train.checkpoint import restore_npz  # noqa: E402
from keras_ocr_tpu_torch import weights  # noqa: E402
from keras_ocr_tpu_torch.models import CRAFT, CRNN, crnn, init_parameters, layers  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
CRNN_KEYS = ("height", "width", "color", "filters", "rnn_units", "dropout",
             "rnn_steps_to_discard", "pool_size", "stn")


def distance(out, ref):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    return f"max {err.max():.3e} mean {err.mean():.3e}"


def port_craft(variables, backbone, fold_bn, width, dtype=torch.bfloat16):
    model = CRAFT(backbone, fold_bn=fold_bn, width=width, dtype=dtype).eval()
    model.load_state_dict(weights.craft_state_dict(variables))
    return model


def float64_sums(self, x, weight, bias):
    """:class:`layers.Conv2d`'s bf16 rule with the conv summed in float64."""
    if x.dtype == weight.dtype:
        return nn.Conv2d._conv_forward(self, x, weight, bias)
    y = nn.Conv2d._conv_forward(self, x.double(), weight.to(x.dtype).double(), None)
    y = y.to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype).reshape(-1, 1, 1)


def craft_case(label, variables, shape, seed, backbone="vgg", fold_bn=False, width=0.25):
    x = np.random.RandomState(seed).randn(*shape, 3).astype(np.float32)
    module = JaxCRAFT(backbone_name=backbone, fold_bn=fold_bn, width=width, dtype=jnp.bfloat16)
    eager = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
    jitted = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x))
    f32 = np.asarray(JaxCRAFT(backbone_name=backbone, fold_bn=fold_bn, width=width).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = port_craft(variables, backbone, fold_bn, width)(torch.from_numpy(x)).numpy()
        naive = port_craft(variables, backbone, fold_bn, width, torch.float32).to(torch.bfloat16)
        naive = naive(torch.from_numpy(x)).float().numpy()
        conv = layers.Conv2d._conv_forward
        layers.Conv2d._conv_forward = float64_sums
        try:
            exact = port_craft(variables, backbone, fold_bn, width)(torch.from_numpy(x)).numpy()
        finally:
            layers.Conv2d._conv_forward = conv
    print(f"CRAFT {label} {shape}: port vs JAX {distance(out, eager)} (max|ref| "
          f"{np.abs(eager).max():.3f}); floors: JAX jitted vs op by op {distance(jitted, eager)}, "
          f"port float64 vs float32 sums {distance(exact, out)}; JAX bf16 vs float32 "
          f"{distance(eager, f32)}; naive .to(bfloat16) vs JAX {distance(naive, eager)}",
          flush=True)


def seeded_b0_tree():
    tree = weights.craft_variables(init_parameters(CRAFT("efficientnetb0"), seed=0))
    rng = np.random.RandomState(0)

    def fill(params, stats):
        for child, node in params.items():
            if "scale" in node:
                shape = node["bias"].shape
                node["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
                node["bias"] = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
                stats[child] = {"mean": rng.uniform(-0.1, 0.1, shape).astype(np.float32),
                                "var": rng.uniform(0.5, 1.5, shape).astype(np.float32)}
            elif "kernel" not in node:
                fill(node, stats[child])

    fill(tree["params"], tree["batch_stats"])
    return tree


def crnn_case(label, build_params, variables, alphabet, batch):
    recognizer = JaxRecognizer(alphabet=alphabet, weights=None, build_params=build_params,
                               compute_dtype=jnp.bfloat16)
    x = np.random.RandomState(0).rand(batch, build_params["height"], build_params["width"],
                                      1).astype(np.float32)
    ref = np.asarray(recognizer.model.apply(variables, jnp.asarray(x), train=False))
    model = CRNN(alphabet_size=len(alphabet), dtype=torch.bfloat16,
                 **{k: build_params[k] for k in CRNN_KEYS})
    model.load_state_dict(weights.crnn_state_dict(variables))
    model.eval()
    top2 = np.sort(ref, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] < 1e-2
    with torch.no_grad():
        for way in ("nn.LSTM", "bilstm_steps"):
            if way == "bilstm_steps":
                model._bilstm = crnn.bilstm_steps
            out = model(torch.from_numpy(x)).numpy()
            moved = out.argmax(-1) != ref.argmax(-1)
            print(f"CRNN {label} ({way}): softmax {distance(out, ref)}; argmax differs at "
                  f"{int(moved.sum())} of {moved.size} frames, {int((moved & near_tie).sum())} "
                  f"of them near ties; JAX near-tie frames {int(near_tie.sum())}", flush=True)


def pipeline_case():
    import torch as _torch

    from keras_ocr_tpu.utils import golden as jgolden
    from keras_ocr_tpu_torch import tools
    from keras_ocr_tpu_torch.utils import golden

    with open(os.path.join(GOLDEN, "expected.json"), encoding="utf8") as f:
        scenes = [entry["image"] for entry in json.load(f)["scenes"]]
    jax_pipeline, _ = jgolden.load_golden_pipeline(GOLDEN, jnp.bfloat16)
    for fold_bn in (False, True):
        port, _ = golden.load_golden_pipeline(GOLDEN, _torch.bfloat16, device="cpu",
                                              fold_bn=fold_bn)
        differ = []
        for scene in scenes:
            image = tools.read(os.path.join(GOLDEN, scene))
            ours = [w for w, _ in port.recognize([image])[0]]
            theirs = [w for w, _ in jax_pipeline.recognize([image])[0]]
            if ours != theirs:
                differ.append((scene, theirs, ours))
        print(f"golden pipeline, bfloat16{', folded' if fold_bn else ''}: {len(scenes)} scenes, "
              f"words differing from JAX's bfloat16 pipeline in {differ or 'none'}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pipeline", action="store_true")
    args = parser.parse_args()
    torch.set_num_threads(4)
    golden_craft = restore_npz(os.path.join(GOLDEN, "detector_slim.npz"))
    jax_init = jax.tree.map(np.asarray, JaxDetector(weights=None, width=0.25,
                                                    max_components=32).variables)
    for shape in ((2, 64, 96), (1, 72, 104)):
        craft_case("golden", golden_craft, shape, seed=0)
        craft_case("JAX init", jax_init, shape, seed=0)
    craft_case("golden, folded", jax.tree.map(np.asarray, fold_bn_variables(golden_craft)),
               (1, 72, 104), seed=2, fold_bn=True)
    craft_case("efficientnetb0", seeded_b0_tree(), (1, 64, 64), seed=1,
               backbone="efficientnetb0", width=1.0)
    with open(os.path.join(GOLDEN, "meta.json"), encoding="utf8") as f:
        meta = json.load(f)
    crnn_case("golden", dict(meta["recognizer_build_params"]),
              restore_npz(os.path.join(GOLDEN, "recognizer_slim.npz")), meta["alphabet"], 4)
    production = JaxRecognizer(weights=None, alphabet=meta["alphabet"])
    variables = jax.tree.map(np.asarray, production.variables)
    rng = np.random.RandomState(0)
    dense2 = variables["params"]["stn"]["dense2"]
    dense2["kernel"] = (rng.randn(*dense2["kernel"].shape) * 0.02).astype(np.float32)
    dense2["bias"] = np.array([0.9, 0.08, 0.05, -0.06, 1.1, 0.03], np.float32)
    crnn_case("production, STN", dict(production.build_params), variables, meta["alphabet"], 2)
    if args.pipeline:
        pipeline_case()
    return 0


if __name__ == "__main__":
    sys.exit(main())
