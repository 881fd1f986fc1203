"""One rank of the 4-process CPU world of ``tests/test_torch_distributed.py``.

Imports torch, numpy and the port only (no JAX), so that a spawned rank
starts quickly. :func:`main` joins a ``gloo`` group, runs every scenario on
the rank's two fake CPU devices (``[torch.device("cpu")] * 2``) and saves
its results as ``rank<r>.pt`` in the shared directory, or its traceback as
``rank<r>.err``. :func:`start_world` spawns the ranks; :func:`join_world`
kills them all when one fails or the deadline passes, and returns every
rank's results.
"""

import datetime
import multiprocessing
import os
import socket
import string
import time
import traceback

import numpy as np
import torch

WORLD = 4
CPU = torch.device("cpu")
ALPHABET = string.ascii_lowercase[:8]
TINY_CRNN = {
    "height": 31, "width": 64, "color": False, "filters": (8, 8, 8, 8, 16, 16, 16),
    "rnn_units": (16, 16), "dropout": 0.0, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}
CRAFT_WIDTH = 0.125


def recognizer_batch(size=8, seed=0):
    """The batch of ``tests/test_torch_parallel_train.py``."""
    rng = np.random.RandomState(seed)
    frames = TINY_CRNN["width"] // 4 - TINY_CRNN["rnn_steps_to_discard"]
    images = rng.rand(size, 31, 64, 1).astype(np.float32)
    label_length = rng.randint(1, 5, size=(size, 1)).astype(np.int32)
    labels = np.full((size, 8), -1, np.int32)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, len(ALPHABET), size=n)
    input_length = np.full((size, 1), frames, np.int32)
    weights = (rng.rand(size) + 0.5).astype(np.float32)
    return (images, labels, input_length, label_length), np.zeros(size), weights


def detector_batch():
    """The batch of ``tests/test_torch_parallel_train.py``."""
    rng = np.random.RandomState(0)
    images = rng.randn(4, 64, 64, 3).astype(np.float32)
    targets = (rng.rand(4, 32, 32, 2) * 0.05).astype(np.float32)
    targets[0, 6:14, 4:20, 0] = rng.uniform(0.3, 1.0, (8, 16))
    targets[2, 20:28, 12:30, 1] = rng.uniform(0.3, 1.0, (8, 18))
    return images, targets, np.array([1.0, 0.5, 2.0, 1.0], np.float32)


def leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


# Meshes by name: (data positions, model) of the global 8 devices. With a
# group each process passes its own 2 devices; without, all 8.
MESHES = {
    "hybrid_4x2x1": lambda parallel, devices: parallel.create_hybrid_mesh(4, (2, 1),
                                                                          devices=devices),
    "4x2": lambda parallel, devices: parallel.create_mesh((4, 2), devices=devices),
    "8x1": lambda parallel, devices: parallel.create_mesh(devices=devices),
}
# Scenario -> (trainer, mesh, dtype, tensor_parallel, dropout).
STEPS = {
    "recognizer_dp": ("recognizer", "hybrid_4x2x1", "float32", False, 0.0),
    "recognizer_tp": ("recognizer", "4x2", "float32", True, 0.0),
    "recognizer_bf16_dp": ("recognizer", "hybrid_4x2x1", "bfloat16", False, 0.0),
    "recognizer_bf16_tp": ("recognizer", "4x2", "bfloat16", True, 0.0),
    "recognizer_dropout": ("recognizer", "8x1", "float32", False, 0.25),
    "detector": ("detector", "4x2", "float64", False, 0.0),
    "detector_bf16": ("detector", "4x2", "bfloat16", False, 0.0),
}


def step(name, variables, devices):
    """One train step of scenario ``name`` from ``variables`` on the mesh
    made of ``devices``: (loss, {path: leaf} after the step)."""
    from keras_ocr_tpu_torch import Detector, Recognizer, parallel
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    kind, mesh_name, dtype, tensor_parallel, dropout = STEPS[name]
    mesh = MESHES[mesh_name](parallel, devices)
    if kind == "recognizer":
        compute = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        recognizer = Recognizer(ALPHABET, None, dict(TINY_CRNN, dropout=dropout), compute,
                                device="cpu").load_variables(variables["crnn"])
        trainer = RecognizerTrainer(recognizer, mesh=mesh, tensor_parallel=tensor_parallel)
        loss = trainer.train_step(recognizer_batch(), torch.Generator().manual_seed(3))
    else:
        compute = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        detector = Detector(weights=None, width=CRAFT_WIDTH, compute_dtype=compute,
                            device="cpu").load_variables(variables["craft"])
        if dtype == "float64":
            detector.model.double()
        trainer = DetectorTrainer(detector, mesh=mesh)
        loss = trainer.train_step(detector_batch())
    return loss, dict(leaves(trainer.variables))


def _collectives(rank, directory, variables):
    """The mesh helpers, the raises, ``fit`` with its callbacks and a
    checkpoint written once and restored on every rank."""
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel
    from keras_ocr_tpu_torch.train import RecognizerTrainer, callbacks, checkpoint

    devices = [CPU] * 2
    out = {"process": (parallel.process_index(), parallel.process_count())}
    mesh = parallel.create_mesh(devices=devices)
    out["spans"] = mesh.spans_processes
    out["local_rows"] = [index for index, _ in parallel.local_rows(mesh)]
    out["remote"] = sorted({d.process_index for d in mesh.devices.ravel()
                            if isinstance(d, parallel.RemoteDevice)})
    shards = parallel.shard_batch(np.arange(16).reshape(16, 1), mesh)
    out["shards"] = [s[:, 0].tolist() for s in shards]
    copies = parallel.shard_params({"w": np.arange(8.0).reshape(2, 4)}, mesh)
    out["param_copies"] = [i for i, copy in enumerate(copies) if copy is not None]
    errors = {}
    for case, fn in (
            ("indivisible", lambda: parallel.shard_batch(np.zeros((12, 1)), mesh)),
            ("model_row_across", lambda: parallel.create_mesh((2, 4), devices=devices)),
            ("hybrid_row_across", lambda: parallel.create_hybrid_mesh(2, (1, 4),
                                                                      devices=devices)),
            ("pipeline", lambda: Pipeline(Detector(weights=None, width=CRAFT_WIDTH, device="cpu"),
                                          Recognizer(ALPHABET, None, TINY_CRNN, device="cpu"),
                                          mesh=mesh))):
        try:
            fn()
            errors[case] = None
        except ValueError as exc:
            errors[case] = str(exc)
    out["errors"] = errors
    recognizer = Recognizer(ALPHABET, None, TINY_CRNN, device="cpu").load_variables(
        variables["crnn"])
    trainer = RecognizerTrainer(recognizer, mesh=parallel.create_hybrid_mesh(
        4, (2, 1), devices=devices))

    def batches():
        while True:
            yield recognizer_batch()

    path = os.path.join(directory, "fit", "best")
    log = os.path.join(directory, "fit", "log.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    out["history"] = trainer.fit(batches(), steps_per_epoch=2, epochs=2, callbacks=[
        callbacks.ModelCheckpoint(path), callbacks.CSVLogger(log)])
    restored = checkpoint.restore(path)
    out["restored_equal"] = all(
        np.array_equal(value, dict(leaves(restored))[key])
        for key, value in leaves(trainer.variables))
    out["variables"] = dict(leaves(trainer.variables))
    with open(log) as f:
        out["log_lines"] = f.read().splitlines()
    return out


def main(rank, port, directory):
    try:
        torch.set_num_threads(1)
        from keras_ocr_tpu_torch import parallel

        parallel.initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                                        rank=rank, world_size=WORLD,
                                        timeout=datetime.timedelta(seconds=120))
        variables = torch.load(os.path.join(directory, "variables.pt"), weights_only=False)
        results = {"steps": {}, "times": {}}
        for name in STEPS:
            start = time.perf_counter()
            results["steps"][name] = step(name, variables, [CPU] * 2)
            results["times"][name] = time.perf_counter() - start
        results["collectives"] = _collectives(rank, directory, variables)
        torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(directory, variables) -> list:
    """Spawn the ranks on ``variables`` (saved to ``directory``); returns
    their processes, for :func:`join_world`."""
    torch.save(variables, os.path.join(directory, "variables.pt"))
    context = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [context.Process(target=main, args=(rank, port, directory), daemon=True)
             for rank in range(WORLD)]
    for proc in procs:
        proc.start()
    return procs


def join_world(procs, directory, deadline) -> list:
    """Every rank's results, or ``RuntimeError`` naming the failed rank and
    its traceback; all ranks are killed as soon as one fails, or at
    ``deadline`` (``time.monotonic()``)."""
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {WORLD} ranks did not finish in time")
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join(10)
    for rank, proc in enumerate(procs):
        if proc.exitcode != 0:
            error = os.path.join(directory, f"rank{rank}.err")
            text = open(error).read() if os.path.exists(error) else "no traceback"
            raise RuntimeError(f"rank {rank} exited with {proc.exitcode}:\n{text}")
    return [torch.load(os.path.join(directory, f"rank{rank}.pt"), weights_only=False)
            for rank in range(WORLD)]
