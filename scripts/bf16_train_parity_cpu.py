"""The floors and the port's distance for one bfloat16 train step on the
CPU: ``JAX_PLATFORMS=cpu python scripts/bf16_train_parity_cpu.py
[--float32-sums]`` (needs both packages; about 5 minutes).

For the tiny CRNN (STN off and on) and the VGG CRAFT (width 0.25, 64x96,
batch 2) of ``tests/test_torch_train_bf16.py``, built with
``compute_dtype=bfloat16``, it prints per gradient leaf, for the loss and
for the running statistics after the step, two distances from the JAX
trainer's step applied op by op (``jax.disable_jit()``): the max error
relative to max(|ref|, 1e-12) and the relative L2 error
||out - ref|| / ||ref||, for

- ``jit``: the JAX trainer's own jitted step (``jax.jit`` of
  ``_train_step``), the floor;
- ``f32``: the JAX float32 model's jitted step (a port step that ran in
  float32 or rounded nowhere sits about that far);
- ``port``: the port's ``RecognizerTrainer`` / ``DetectorTrainer`` step on
  the same weights and batch;
- ``port_f32``: the port's float32 model's step (the tests' negative
  control).

Leaves whose gradient is zero in exact arithmetic are marked ``(zero)``.
``--float32-sums`` runs both JAX steps with every bfloat16 ``reduce_sum``
accumulated in float32 and rounded once: XLA:CPU accumulates the transpose
of a bf16 broadcast (a bias gradient) in bf16, one element after another,
so that 2048 ones sum to 256 (printed first). The gradients come out of the
JAX trainers' steps through an optimiser whose state is the last gradient
(its updates are zero).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax._src.lax import lax as lax_internal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

import test_torch_train_bf16 as t  # noqa: E402


@contextlib.contextmanager
def float32_sums(on):
    """JAX's ``lax.reduce_sum`` on a bf16 operand accumulated in float32
    and rounded once (the transpose rules call it by its module name)."""
    original = lax_internal.reduce_sum

    def reduce_sum(operand, axes, *args, **kwargs):
        if getattr(operand, "dtype", None) == jnp.bfloat16:
            wide = original(operand.astype(jnp.float32), axes, *args, **kwargs)
            return wide.astype(jnp.bfloat16)
        return original(operand, axes, *args, **kwargs)

    if on:
        lax_internal.reduce_sum = reduce_sum
    try:
        yield
    finally:
        lax_internal.reduce_sum = original


def bias_sum_demo():
    def loss(bias):
        y = jnp.ones((8, 16, 16, 1), jnp.bfloat16) + bias.astype(jnp.bfloat16)
        return y.astype(jnp.float32).sum()

    with jax.disable_jit():
        grad = float(jax.grad(loss)(jnp.zeros(1))[0])
    print(f"gradient of a bf16 bias broadcast over 2048 elements of gradient 1: {grad}")


def report(label, ref, steps, zero):
    names = list(steps)
    print(f"\n{label}: relative to the JAX bf16 step op by op; per column "
          f"max-relative / relative-L2 of {', '.join(names)}")
    print(f"  loss {ref['loss']:.6f}: " + "  ".join(
        f"{abs(steps[n]['loss'] - ref['loss']) / abs(ref['loss']):.3e}" for n in names))
    for part in ("grads", "stats"):
        rows = {n: (t.max_relative(steps[n][part], ref[part]),
                    t.l2_relative(steps[n][part], ref[part])) for n in names}
        paths = sorted(rows[names[0]][0])
        for path in paths:
            mark = " (zero)" if part == "grads" and path in zero else ""
            print(f"  {part} {path}{mark}: " + "  ".join(
                f"{rows[n][0][path]:.3e}/{rows[n][1][path]:.3e}" for n in names))
        kept = [p for p in paths if part != "grads" or p not in zero]
        print(f"  {part} worst{' (zero leaves left out)' if part == 'grads' else ''}: "
              + "  ".join(f"{max(rows[n][0][p] for p in kept):.3e}/"
                          f"{max(rows[n][1][p] for p in kept):.3e}" for n in names))
    if zero:
        tree = dict(t.leaves(ref["grads"]))
        largest = max(np.abs(value).max() for value in tree.values())
        print("  zero leaves, max |grad| / the model's largest: " + "  ".join(
            f"{n} {max(np.abs(dict(t.leaves(steps[n]['grads']))[p]).max() for p in zero) / largest:.3e}"
            for n in names) + f"  ref {max(np.abs(tree[p]).max() for p in zero) / largest:.3e}")
    print(flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--float32-sums", action="store_true",
                        help="accumulate JAX's bf16 reduce_sums in float32")
    args = parser.parse_args()
    if args.float32_sums:
        bias_sum_demo()
    for stn in (False, True):
        variables = t.crnn_variables(stn)
        with float32_sums(args.float32_sums):
            ref = t.jax_crnn_step(variables, stn)
            steps = {"jit": t.jax_crnn_step(variables, stn, eager=False)}
        steps["f32"] = t.jax_crnn_step(variables, stn, jnp.float32, eager=False)
        steps["port"] = t.port_crnn_step(variables, stn)
        steps["port_f32"] = t.port_crnn_step(variables, stn, torch.float32)
        report(f"CRNN (stn={stn})", ref, steps, t.zero_leaves(steps["port_f32"]["grads"]))
    variables = t.craft_variables()
    with float32_sums(args.float32_sums):
        ref = t.jax_craft_step(variables)
        steps = {"jit": t.jax_craft_step(variables, eager=False)}
    steps["f32"] = t.jax_craft_step(variables, jnp.float32, eager=False)
    steps["port"] = t.port_craft_step(variables)
    steps["port_f32"] = t.port_craft_step(variables, torch.float32)
    report(f"CRAFT VGG width {t.CRAFT_WIDTH} {t.CRAFT_SHAPE}", ref, steps,
           t.zero_leaves(steps["port_f32"]["grads"]))


if __name__ == "__main__":
    main()
