"""Port parity of the bfloat16 CRAFT train step on the CPU: the VGG CRAFT at
width 0.25 on a (2, 64, 96) batch, one ``DetectorTrainer`` step against the
JAX trainer's step op by op, and on two CPU devices against the one-device
step. The bars, their floors and the helpers are those of
``tests/test_torch_train_bf16.py``; a file of its own, so that the JAX
step's op-by-op run (about 90 s) and the CRNN's run in parallel.
"""

import os
import sys

import pytest
import torch

from keras_ocr_tpu_torch.parallel import mesh as mesh_lib

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train_bf16 import (CPU, assert_float32_state, assert_step_close,  # noqa: E402
                                   check_against_jax, craft_variables, jax_craft_step,
                                   port_craft_step, zero_leaves)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def craft_case():
    variables = craft_variables()
    return {"variables": variables, "jax": jax_craft_step(variables),
            "float32": port_craft_step(variables, torch.float32)}



def test_craft_bf16_step_matches_jax(craft_case):
    step = port_craft_step(craft_case["variables"])
    assert step["trainer"].detector.model.dtype == torch.bfloat16
    check_against_jax(craft_case, step)


def test_craft_bf16_step_on_a_mesh_matches_one_device(craft_case):
    one = port_craft_step(craft_case["variables"])
    step = port_craft_step(craft_case["variables"],
                           mesh=mesh_lib.create_mesh(devices=[CPU] * 2))
    assert_float32_state(step)
    assert_step_close(step, one, zero_leaves(craft_case["float32"]["grads"]), "data_parallel")
