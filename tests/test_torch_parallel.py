"""The port's multi-device layer (``keras_ocr_tpu_torch/parallel``) against
the JAX package's on its 8 fake CPU devices, with the port's fake devices
``[torch.device("cpu")] * n`` (``torch.device("cpu", i)`` where the test
follows a device through the grid).

- ``create_mesh`` / ``create_hybrid_mesh`` shapes and device order, the
  shardings' partition specs, ``crnn_param_sharding``'s selection leaf by
  leaf, ``shard_batch`` and ``shard_params`` shard by shard;
- ``Pipeline(mesh=...)`` on 3 images (padding to the mesh): the words of
  the port's unsharded pipeline and of JAX's sharded one exactly, boxes
  within 1e-4 (``tests/test_pipeline.py``'s sharded case, slim models); a
  mesh with a ``model`` axis runs a VGG and an EfficientNet detector on
  row strips (``tests/test_torch_spatial.py``,
  ``tests/test_torch_spatial_efficientnet.py``);
- BatchNorm over a replica group equals BatchNorm on the whole batch
  (outputs, gradients, running statistics).

The trainers on a mesh: ``tests/test_torch_parallel_train.py``. The JAX
computations are module fixtures.
"""

import string
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_ocr_tpu.detection import Detector as JaxDetector
from keras_ocr_tpu.parallel import mesh as jmesh
from keras_ocr_tpu.pipeline import Pipeline as JaxPipeline
from keras_ocr_tpu.recognition import Recognizer as JaxRecognizer
from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel
from keras_ocr_tpu_torch.models.layers import BatchNorm2d
from keras_ocr_tpu_torch.parallel import mesh as mesh_lib
from keras_ocr_tpu_torch.parallel import replicas

torch.set_num_threads(2)

CPU = torch.device("cpu")
INDEXED = [torch.device("cpu", i) for i in range(8)]
TINY_CRNN = {
    "height": 31, "width": 64, "color": False, "filters": (8, 8, 8, 8, 16, 16, 16),
    "rnn_units": (16, 16), "dropout": 0.0, "rnn_steps_to_discard": 2, "pool_size": 2,
    "stn": False,
}
ALPHABET = string.ascii_lowercase[:8]
# Slim models for the pipeline: JAX's sharded case at a width that compiles fast.
SLIM_CRNN = dict(TINY_CRNN, width=200, filters=(8,) * 7, rnn_units=(8, 8))
PIPELINE_ALPHABET = string.digits + string.ascii_lowercase
DETECTION_KWARGS = {"detection_threshold": -10.0, "text_threshold": -10.0,
                    "link_threshold": 10.0, "size_threshold": 1}
MESHES = {
    "create_mesh": (lambda m, d: m.create_mesh(devices=d), {"data": 8, "model": 1}),
    "4x2": (lambda m, d: m.create_mesh((4, 2), devices=d), {"data": 4, "model": 2}),
    "hybrid_2x2x2": (lambda m, d: m.create_hybrid_mesh(2, (2, 2), devices=d),
                     {"slice": 2, "data": 2, "model": 2}),
    "hybrid_2_default": (lambda m, d: m.create_hybrid_mesh(2, devices=d),
                         {"slice": 2, "data": 4, "model": 1}),
}


def _leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _jax_mesh(name):
    return MESHES[name][0](jmesh, jax.devices())


def _port_mesh(name, devices=None):
    return MESHES[name][0](mesh_lib, devices or [CPU] * 8)


@pytest.mark.parametrize("name", MESHES)
def test_meshes_match_jax(name):
    ours, theirs = _port_mesh(name, INDEXED), _jax_mesh(name)
    assert dict(ours.shape) == dict(theirs.shape) == MESHES[name][1]
    assert ours.axis_names == tuple(theirs.axis_names) and ours.size == 8
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(ours.devices), ids)
    assert all(isinstance(d, torch.device) for d in ours.devices.ravel())


@pytest.mark.parametrize("name", MESHES)
def test_shardings_match_jax(name):
    ours, theirs = _port_mesh(name), _jax_mesh(name)
    for fn in ("batch_sharding", "replicated", "spatial_sharding"):
        assert getattr(mesh_lib, fn)(ours).spec == tuple(getattr(jmesh, fn)(theirs).spec), fn
    if "slice" in ours.axis_names:
        assert (mesh_lib.hybrid_batch_sharding(ours).spec
                == tuple(jmesh.hybrid_batch_sharding(theirs).spec))


@pytest.fixture(scope="module")
def jax_recognizer():
    recognizer = JaxRecognizer(ALPHABET, None, TINY_CRNN)
    return recognizer, jax.tree.map(np.asarray, recognizer.variables)


@pytest.mark.parametrize("classes", [8, 9])
@pytest.mark.parametrize("name", ["create_mesh", "4x2", "hybrid_2x2x2"])
def test_crnn_param_sharding_matches_jax(jax_recognizer, name, classes):
    """With 8 letters fc_12 has 9 columns, which do not divide 2."""
    _, variables = jax_recognizer
    if classes == 8:
        fc_12 = variables["params"]["fc_12"]
        variables = {**variables, "params": {**variables["params"], "fc_12": {
            "kernel": fc_12["kernel"][:, :8], "bias": fc_12["bias"][:8]}}}
    ours = dict(_leaves(mesh_lib.crnn_param_sharding(_port_mesh(name))(variables)))
    theirs = dict(_leaves(jmesh.crnn_param_sharding(_jax_mesh(name))(variables)))
    assert ours.keys() == theirs.keys()
    for path, sharding in theirs.items():
        assert ours[path].spec == tuple(sharding.spec), path
    split = {path for path, s in ours.items() if s.spec}
    assert "params/lstm_10/recurrent_kernel" in split
    assert ("params/fc_12/kernel" in split) == (classes == 8 or name == "create_mesh")


@pytest.mark.parametrize("name", MESHES)
def test_shard_batch_matches_jax(name):
    """Shard i of the port's split is the rows JAX puts on the device of
    data position i; an indivisible batch raises as ``device_put`` does."""
    ours, theirs = _port_mesh(name, INDEXED), _jax_mesh(name)
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "y": (np.arange(8),)}
    shards = mesh_lib.shard_batch(batch, ours)
    on_device = {s.device.id: np.asarray(s.data) for s in jmesh.shard_batch(batch, theirs)["x"]
                 .addressable_shards}
    rows = mesh_lib.data_rows(ours)
    assert len(shards["x"]) == len(rows) == mesh_lib.data_size(ours)
    for shard, label, row in zip(shards["x"], shards["y"][0], rows):
        assert shard.device == mesh_lib.canonical_device(row[0])
        np.testing.assert_array_equal(shard.numpy(), on_device[row[0].index])
        np.testing.assert_array_equal(label.numpy(), shard.numpy()[:, 0] // 3)
    with pytest.raises(ValueError):
        jmesh.shard_batch(np.zeros((3, 2)), theirs)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(np.zeros((3, 2)), ours)


@pytest.mark.parametrize("rules", [False, True], ids=["replicated", "crnn_rules"])
def test_shard_params_matches_jax(jax_recognizer, rules):
    _, variables = jax_recognizer
    ours, theirs = _port_mesh("4x2", INDEXED), _jax_mesh("4x2")
    copies = mesh_lib.shard_params(
        variables, ours, mesh_lib.crnn_param_sharding(ours) if rules else None)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, variables), theirs,
                                 jmesh.crnn_param_sharding(theirs) if rules else None)
    assert len(copies) == 8
    flat = dict(_leaves(sharded))
    for device, tree in zip(ours.devices.ravel(), copies):
        for path, leaf in _leaves(tree):
            assert leaf.device == mesh_lib.canonical_device(device)
            ref = next(np.asarray(s.data) for s in flat[path].addressable_shards
                       if s.device.id == device.index)
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=path)
    # Fresh copies: writing one leaves the tree and the other copies alone.
    copies[0]["params"]["fc_9"]["bias"].add_(1.0)
    assert not np.array_equal(copies[0]["params"]["fc_9"]["bias"].numpy(),
                              variables["params"]["fc_9"]["bias"])
    np.testing.assert_array_equal(copies[1]["params"]["fc_9"]["bias"].numpy(),
                                  variables["params"]["fc_9"]["bias"])


def test_default_mesh_and_distributed_start(monkeypatch):
    """Without a card the default mesh raises naming ``devices=``; on one
    process ``initialize_distributed`` starts nothing, as JAX's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        parallel.create_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        parallel.create_hybrid_mesh(2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    parallel.initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="does not hold"):
        parallel.create_mesh((3, 2), devices=[CPU] * 8)


# --- the pipeline ------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline_models():
    """A slim JAX detector and recognizer, and the port's on their weights."""
    jax_detector = JaxDetector(weights=None, width=0.125, max_components=16)
    jax_recognizer = JaxRecognizer(PIPELINE_ALPHABET, None, SLIM_CRNN)
    detector = Detector(weights=None, width=0.125, max_components=16, device="cpu")
    detector.load_variables(jax.tree.map(np.asarray, jax_detector.variables))
    recognizer = Recognizer(PIPELINE_ALPHABET, None, SLIM_CRNN, device="cpu")
    recognizer.load_variables(jax.tree.map(np.asarray, jax_recognizer.variables))
    return (jax_detector, jax_recognizer), (detector, recognizer)


def _images():
    """3 images, which do not divide 8 (the batch is padded), small enough
    that each whole-image box fits the first warp window: one compile."""
    rng = np.random.RandomState(0)
    images = []
    for _ in range(3):
        image = np.zeros((24, 40, 3), dtype="uint8")
        x, y = rng.randint(0, 20), rng.randint(0, 10)
        image[y : y + 10, x : x + 18] = 255
        images.append(image)
    return images


@pytest.fixture(scope="module")
def jax_sharded_reading(pipeline_models):
    (detector, recognizer), _ = pipeline_models
    sharded = JaxPipeline(detector, recognizer, 2, 2048, 8, 8, None,
                          jmesh.create_mesh(shape=(len(jax.devices()), 1)))
    return sharded.recognize(_images(), detection_kwargs=DETECTION_KWARGS)


def _assert_same(results, reference):
    assert len(results) == len(reference) == 3
    for got, want in zip(results, reference):
        assert [w for w, _ in got] == [w for w, _ in want] and got
        for (_, box), (_, ref) in zip(got, want):
            np.testing.assert_allclose(box, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["create_mesh", "hybrid_2_default"])
def test_pipeline_on_a_mesh_matches(pipeline_models, jax_sharded_reading, name):
    _, (detector, recognizer) = pipeline_models
    mesh = _port_mesh(name)
    sharded = Pipeline(detector, recognizer, 2, 2048, 8, 8, None, mesh)
    plain = Pipeline(detector, recognizer, 2, 2048, 8, 8)
    assert sharded.mesh is mesh and len(sharded._shard_devices) == 8
    batch, _, num_real, _ = sharded._prepare(_images())
    assert num_real == 3 and [len(shard) for shard in batch] == [1] * 8
    assert not batch[-1].any()  # a zero image pads the batch
    results = sharded.recognize(_images(), detection_kwargs=DETECTION_KWARGS)
    assert sharded.last_run_stats["warp_escalations"] == 0
    _assert_same(results, plain.recognize(_images(), detection_kwargs=DETECTION_KWARGS))
    _assert_same(results, jax_sharded_reading)
    many = sharded.recognize_many(_images() * 2, batch_size=4, detection_kwargs=DETECTION_KWARGS)
    assert [[w for w, _ in r] for r in many] == [[w for w, _ in r] for r in results * 2]


@pytest.fixture(scope="module")
def efficientnet_detector(tmp_path_factory):
    """A B0 detector built offline: no network, empty weight directories
    (the ImageNet backbone file is missing, so it warns and stays random)."""
    root = tmp_path_factory.mktemp("offline")
    with pytest.MonkeyPatch.context() as patch:
        def refuse(*args, **kwargs):
            raise OSError("no network in the tests")

        patch.setattr(urllib.request, "urlopen", refuse)
        patch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(root / "vendored"))
        patch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(root / "cache"))
        patch.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
        with pytest.warns(UserWarning, match="ImageNet"):
            return Detector(weights=None, backbone_name="efficientnetb0", device="cpu")


@pytest.mark.parametrize("name", ["4x2", "hybrid_2x2x2"])
def test_pipeline_refuses_a_model_axis(pipeline_models, efficientnet_detector, name):
    """A mesh with a ``model`` axis: a VGG and an EfficientNet detector
    both run on its row strips (``tests/test_torch_spatial.py``,
    ``tests/test_torch_spatial_efficientnet.py``); a JAX mesh is refused
    with ``TypeError``."""
    _, (detector, recognizer) = pipeline_models
    assert Pipeline(efficientnet_detector, recognizer,
                    mesh=_port_mesh(name))._strips[0] is not None
    assert Pipeline(detector, recognizer, mesh=_port_mesh(name))._strips[0] is not None
    with pytest.raises(TypeError, match="Mesh"):
        Pipeline(detector, recognizer, mesh=_jax_mesh(name))


# --- cross-replica BatchNorm -------------------------------------------------


def test_batch_norm_over_replicas_is_the_whole_batch():
    """4 shards of an (8, 5, 3, 4) batch through one BatchNorm in a replica
    group: outputs, input and parameter gradients and running statistics
    equal the BatchNorm of the whole batch."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 5, 3, 4) * 3 + 1).requires_grad_()
    upstream = torch.from_numpy(rng.randn(8, 5, 3, 4))
    whole, group_bn = BatchNorm2d(5).double(), BatchNorm2d(5).double()
    with torch.no_grad():
        for bn in (whole, group_bn):
            bn.weight.copy_(torch.linspace(0.5, 1.5, 5, dtype=torch.float64))
            bn.bias.copy_(torch.linspace(-1, 1, 5, dtype=torch.float64))
    ref = whole(x)
    (ref * upstream).sum().backward()
    ref_grads = [x.grad.clone(), whole.weight.grad, whole.bias.grad]
    x.grad = None
    group = replicas.ReplicaGroup(4)
    outs = group.run(lambda rank: group_bn(x[2 * rank : 2 * rank + 2]))
    out = torch.cat(outs)
    (out * upstream).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-12)
    for got, want in zip([x.grad, group_bn.weight.grad, group_bn.bias.grad], ref_grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(group_bn, name), getattr(whole, name), rtol=0,
                                   atol=1e-12)


def test_replica_group_raises_the_first_error_without_hanging():
    group = replicas.ReplicaGroup(3)

    def fn(rank):
        if rank == 1:
            raise KeyError("rank 1")
        return group.gather(rank, rank)

    done = []
    thread = threading.Thread(target=lambda: done.append(pytest.raises(KeyError, group.run, fn)))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive() and done
    assert group.run(lambda rank: group.gather(rank, rank * 2)) == [[0, 2, 4]] * 3


def test_module_replicas_copy_to_other_devices():
    """A module on its own device is its own replica; elsewhere ("meta"
    stands in for a second device) one copy, kept while the module stands,
    made anew for another module, following its train / eval mode."""
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), BatchNorm2d(2))
    cache = replicas.ModuleReplicas()
    assert cache.get(module, CPU) is module and cache.get(module, "cpu:3") is module
    copy = cache.get(module, "meta")
    assert copy is not module and next(copy.parameters()).device.type == "meta"
    with torch.no_grad():
        module[0].weight.add_(1.0)
    module.train()
    assert cache.get(module, "meta") is copy and copy.training
    other = torch.nn.Linear(3, 2)
    assert cache.get(other, "meta") is not copy
    assert cache.get(torch.nn.ReLU(), "meta") is not None  # nothing to copy
