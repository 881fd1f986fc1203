"""Float32 rounding against float64 in one CRAFT train step and in three
trainer steps, for the JAX package and the port, on the CPU:
``JAX_PLATFORMS=cpu python3 scripts/train_parity_cpu.py``.

CRAFT at width 0.125, 64x64, batch 2, from the JAX package's seeded
initial variables (the configuration of ``tests/test_torch_train_detector.py``):
the worst gradient leaf of each float32 step against the JAX float64 step
(max |g - g64| over the leaf's max |g64|; leaves that are zero in exact
arithmetic left out), then the losses of three MSE + Adam trainer steps of
each package in float32 and float64. Parity numbers, not device metrics.
"""

from __future__ import annotations

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from keras_ocr_tpu.detection import Detector as JaxDetector  # noqa: E402
from keras_ocr_tpu.models.craft import CRAFT as JaxCRAFT  # noqa: E402
from keras_ocr_tpu.parallel import mesh as mesh_lib  # noqa: E402
from keras_ocr_tpu.train import DetectorTrainer as JaxDetectorTrainer  # noqa: E402
from keras_ocr_tpu_torch import Detector, weights  # noqa: E402
from keras_ocr_tpu_torch.train import DetectorTrainer  # noqa: E402

WIDTH = 0.125


def leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float64)


def worst(ours, ref):
    largest = max(np.abs(v).max() for v in ref.values())
    return max((np.abs(ours[k] - v).max() / np.abs(v).max(), k)
               for k, v in ref.items() if np.abs(v).max() > 1e-9 * largest)


def batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    targets = (rng.rand(2, 32, 32, 2) * 0.05).astype(np.float32)
    targets[0, 6:14, 4:20, 0] = rng.uniform(0.3, 1.0, (8, 16))
    targets[0, 8:12, 10:26, 1] = rng.uniform(0.3, 1.0, (4, 16))
    targets[1, 20:28, 12:30, 0] = rng.uniform(0.3, 1.0, (8, 18))
    return images, targets, np.array([1.0, 0.5], np.float32)


def jax_gradients(variables, dtype):
    images, targets, sample_weights = batch(0)
    model = JaxCRAFT(width=WIDTH, dtype=dtype)
    tree = jax.tree.map(lambda leaf: np.asarray(leaf, dtype), variables)

    def loss_fn(params):
        preds, _ = model.apply({"params": params, "batch_stats": tree["batch_stats"]},
                               images.astype(dtype), train=True, mutable=["batch_stats"])
        per_sample = jnp.mean((preds - targets.astype(dtype)) ** 2, axis=(1, 2, 3))
        return jnp.mean(per_sample * sample_weights.astype(dtype))

    return dict(leaves(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(tree["params"]))))


def port_gradients(variables, dtype):
    detector = Detector(weights=None, width=WIDTH, device="cpu").load_variables(variables)
    detector.model.to(dtype)
    trainer = DetectorTrainer(detector)
    trainer.train_step(batch(0))
    state = dict(detector.model.state_dict())
    state.update({name: p.grad for name, p in detector.model.named_parameters()})
    return dict(leaves(weights.craft_variables(state)["params"]))


def jax_trajectory(variables, dtype):
    holder = types.SimpleNamespace(
        model=JaxCRAFT(width=WIDTH, dtype=dtype),
        variables=jax.tree.map(lambda leaf: jnp.asarray(leaf, dtype), variables))
    trainer = JaxDetectorTrainer(holder, mesh=mesh_lib.create_mesh(devices=jax.devices()[:1]))
    return [trainer.train_step(batch(1)) for _ in range(3)]


def port_trajectory(variables, dtype):
    detector = Detector(weights=None, width=WIDTH, device="cpu").load_variables(variables)
    detector.model.to(dtype)
    trainer = DetectorTrainer(detector)
    return [trainer.train_step(batch(1)) for _ in range(3)]


def main() -> int:
    torch.set_num_threads(4)
    variables = jax.tree.map(np.asarray, JaxDetector(weights=None, width=WIDTH,
                                                     max_components=16).variables)
    with jax.enable_x64(True):
        reference = jax_gradients(variables, jnp.float64)
        wide = jax_trajectory(variables, jnp.float64)
    print("CRAFT width 0.125, 2x64x64, one MSE step, worst gradient leaf against JAX float64:")
    for label, grads in (("JAX float32", jax_gradients(variables, jnp.float32)),
                         ("port float32", port_gradients(variables, torch.float32)),
                         ("port float64", port_gradients(variables, torch.float64))):
        error, leaf = worst(grads, reference)
        print(f"  {label}: {error:.3e} ({leaf})")
    print("three MSE + Adam trainer steps, losses, and the third against JAX float64:")
    for label, losses in (("JAX float64", wide),
                          ("JAX float32", jax_trajectory(variables, jnp.float32)),
                          ("port float32", port_trajectory(variables, torch.float32)),
                          ("port float64", port_trajectory(variables, torch.float64))):
        print(f"  {label}: {[f'{v:.8f}' for v in losses]}, third "
              f"{abs(losses[2] - wide[2]) / wide[2]:.3e} relative")
    return 0


if __name__ == "__main__":
    sys.exit(main())
