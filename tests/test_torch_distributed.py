"""The port's trainers on a mesh across processes: 4 ``gloo`` CPU ranks
with 2 fake CPU devices each (``tests/torch_distributed_worker.py``).

One world for the file (a module fixture spawns the 4 ranks, each runs
every scenario, and the tests read the results): one ``RecognizerTrainer``
step on the hybrid (4, 2, 1) mesh (``slice`` across the processes), with
``tensor_parallel=True`` on (4, 2) (each ``model`` row within a process),
both in float32 and bf16, with dropout on (8, 1), and one
``DetectorTrainer`` step on (4, 2) in float64 and bf16. Each is held
against the same step on the one-process port mesh of the same global
shape (8 fake devices) with the bars of
``tests/test_torch_parallel_train.py`` (loss 1e-4 relative, parameters and
running statistics 1e-4 * max(1, max|ref|)), and in float32 / float64
against JAX's step on the same mesh of ``tests/conftest.py``'s 8 fake
devices at the same bars (a bf16 step has no such bar against JAX, whose
jitted step differs from its own op-by-op step by more: its one-process
mesh is held to JAX in ``tests/test_torch_train_bf16.py``). Every rank's
parameters are bit for bit rank 0's. The ranks run while the references
are computed. Also: each rank holds its own data positions and
shards, a ``model`` row across processes and ``Pipeline`` on a mesh across
processes raise, ``fit`` logs the same losses on every rank, and a
checkpoint written once (rank 0) is restored on every rank.
"""

import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.models.craft import CRAFT as JaxCRAFT
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu.train import DetectorTrainer as JaxDetectorTrainer
from keras_ocr_tpu.train import RecognizerTrainer as JaxRecognizerTrainer
from keras_ocr_tpu_torch import parallel

sys.path.insert(0, os.path.dirname(__file__))
import torch_distributed_worker as worker  # noqa: E402

torch.set_num_threads(2)

LOSS_BAR = 1e-4
PARAM_BAR = 1e-4


@pytest.fixture(scope="module")
def variables():
    return {
        "crnn": jax.tree.map(np.asarray, JaxRecognizer(worker.ALPHABET, None,
                                                        worker.TINY_CRNN).variables),
        "craft": jax.tree.map(np.asarray, JaxDetector(weights=None,
                                                      width=worker.CRAFT_WIDTH).variables),
    }


WORLD_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def started(variables, tmp_path_factory):
    """The ranks, spawned first, so that the references below compute
    while they run; killed at the end of the module whatever happens."""
    directory = str(tmp_path_factory.mktemp("world"))
    procs = worker.start_world(directory, variables)
    yield procs, directory, time.monotonic() + WORLD_TIMEOUT
    for proc in procs:
        if proc.is_alive():
            proc.kill()


@pytest.fixture(scope="module")
def one_process(variables, started):
    """Each step on the one-process port mesh of the same global shape."""
    return {name: worker.step(name, variables, [worker.CPU] * 8) for name in worker.STEPS}


@pytest.fixture(scope="module")
def world(started, one_process, jax_steps):
    """Every rank's results."""
    return worker.join_world(*started)


JAX_MESHES = {
    "hybrid_4x2x1": lambda: jmesh.create_hybrid_mesh(4, (2, 1)),
    "4x2": lambda: jmesh.create_mesh((4, 2)),
}


@pytest.fixture(scope="module")
def jax_steps(variables, started):
    """JAX's recognizer steps on each mesh and its CRAFT step in float64 on
    (4, 1)."""
    steps = {}
    for name in ("recognizer_dp", "recognizer_tp"):
        _, mesh_name, _, tensor_parallel, _ = worker.STEPS[name]
        recognizer = JaxRecognizer(worker.ALPHABET, None, worker.TINY_CRNN)
        recognizer.variables = jax.tree.map(jnp.asarray, variables["crnn"])
        trainer = JaxRecognizerTrainer(recognizer, mesh=JAX_MESHES[mesh_name](),
                                       tensor_parallel=tensor_parallel)
        loss = trainer.train_step(worker.recognizer_batch(), jax.random.PRNGKey(0))
        steps[name] = loss, dict(worker.leaves(jax.tree.map(np.asarray, trainer.variables)))
    with jax.enable_x64(True):
        wide = types.SimpleNamespace(
            model=JaxCRAFT(width=worker.CRAFT_WIDTH, dtype=jnp.float64),
            variables=jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64),
                                   variables["craft"]))
        trainer = JaxDetectorTrainer(wide, mesh=jmesh.create_mesh(
            shape=(4, 1), devices=jax.devices()[:4]))
        loss = trainer.train_step(worker.detector_batch())
        steps["detector"] = loss, dict(worker.leaves(jax.tree.map(np.asarray,
                                                                  trainer.variables)))
    return steps


def _assert_step_close(ours, ref, what):
    (loss, leaves), (ref_loss, ref_leaves) = ours, ref
    assert abs(loss - ref_loss) <= LOSS_BAR * abs(ref_loss), (what, loss, ref_loss)
    assert leaves.keys() == ref_leaves.keys()
    for path, value in ref_leaves.items():
        value = np.asarray(value, np.float64)
        err = np.abs(np.asarray(leaves[path], np.float64) - value).max()
        assert err <= PARAM_BAR * max(1.0, np.abs(value).max()), (what, path, err)


@pytest.mark.parametrize("name", list(worker.STEPS))
def test_step_across_processes_matches_one_process(world, one_process, name):
    for rank, results in enumerate(world):
        _assert_step_close(results["steps"][name], one_process[name], (name, rank))


@pytest.mark.parametrize("name", list(worker.STEPS))
def test_ranks_hold_bit_equal_parameters(world, name):
    loss, leaves = world[0]["steps"][name]
    for results in world[1:]:
        other_loss, other = results["steps"][name]
        assert other_loss == loss
        assert other.keys() == leaves.keys()
        for path, value in leaves.items():
            assert np.array_equal(other[path], value), (name, path)


@pytest.mark.parametrize("name", ["recognizer_dp", "recognizer_tp", "detector"])
def test_step_across_processes_matches_jax(world, jax_steps, name):
    _assert_step_close(world[0]["steps"][name], jax_steps[name], name)


def test_each_rank_holds_its_own_positions(world):
    for rank, results in enumerate(world):
        out = results["collectives"]
        assert out["process"] == (rank, worker.WORLD)
        assert out["spans"]
        assert out["local_rows"] == [2 * rank, 2 * rank + 1]
        assert out["remote"] == [r for r in range(worker.WORLD) if r != rank]
        assert out["shards"] == [[4 * rank, 4 * rank + 1], [4 * rank + 2, 4 * rank + 3]]
        # One copy of a variable tree per device of this process, none for
        # the others'.
        assert out["param_copies"] == [2 * rank, 2 * rank + 1]


@pytest.mark.parametrize("case", ["indivisible", "model_row_across", "hybrid_row_across",
                                  "pipeline"])
def test_cross_process_misuse_raises(world, case):
    match = {"indivisible": "does not divide over the 8 data positions",
             "model_row_across": "spans processes", "hybrid_row_across": "spans processes",
             "pipeline": "this process's devices only"}[case]
    for results in world:
        error = results["collectives"]["errors"][case]
        assert error is not None and match in error, error


def test_fit_logs_the_same_losses_and_restores_one_checkpoint_everywhere(world):
    history = world[0]["collectives"]["history"]
    assert len(history) == 2 and history[1] < history[0]
    for results in world:
        out = results["collectives"]
        assert out["history"] == history
        assert out["restored_equal"]
        for path, value in world[0]["collectives"]["variables"].items():
            assert np.array_equal(out["variables"][path], value), path
        # One header and one row an epoch: rank 0 alone wrote the log.
        assert len(out["log_lines"]) == 3 and out["log_lines"][0] == "epoch,loss"


def test_without_a_group_meshes_stay_in_process(variables):
    """``initialize_distributed`` is a no-op at world size 1 and meshes hold
    this process's devices only."""
    parallel.initialize_distributed(backend="gloo", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    mesh = parallel.create_mesh((2, 4), devices=[worker.CPU] * 8)
    assert not mesh.spans_processes
    assert [i for i, _ in parallel.local_rows(mesh)] == [0, 1]
