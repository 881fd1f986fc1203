"""The port's weight files against the JAX package's: the ``.h5`` and
``.pth`` writers and loaders both ways, bit for bit; the registry lookup
offline (``urlopen`` refused, so the network is never reached); and the
round trips with h5py, jax, flax and PIL unimportable.
"""

import hashlib
import io
import os
import subprocess
import sys
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from keras_ocr_tpu import weights as jweights
from keras_ocr_tpu.weights import export as jexport
from keras_ocr_tpu_torch import tools, weights
from keras_ocr_tpu_torch.models import CRAFT, CRNN

h5py = pytest.importorskip("h5py")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLIM_CRNN = dict(height=31, width=200, color=False, filters=(8,) * 7, rnn_units=(8, 8),
                 dropout=0.25, rnn_steps_to_discard=2, pool_size=2)


def _filled(tree, seed):
    """The tree's shapes with seeded values in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            return {key: fill(node[key]) for key in sorted(node)}
        return rng.uniform(0.5, 1.5, np.shape(node)).astype(np.float32)

    return fill(tree)


def _craft_tree(seed=0):
    return _filled(weights.craft_variables(CRAFT(width=0.25)), seed)


def _crnn_tree(stn=True, seed=1):
    return _filled(weights.crnn_variables(CRNN(alphabet_size=36, stn=stn, **SLIM_CRNN)), seed)


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        out.update(_leaves(value, path) if isinstance(value, dict) else {path: value})
    return out


def assert_trees_identical(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        ours = np.asarray(got[key])
        assert ours.dtype == np.asarray(value).dtype and ours.shape == np.shape(value), key
        assert ours.tobytes() == np.ascontiguousarray(value).tobytes(), key


@pytest.fixture()
def offline(tmp_path, monkeypatch):
    """Vendored dir and cache under ``tmp_path``; ``urlopen`` refused."""
    calls = []

    def refuse(url, *args, **kwargs):
        calls.append(url)
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("KERAS_OCR_TPU_VENDORED_WEIGHTS", str(tmp_path / "vendored"))
    monkeypatch.setenv("KERAS_OCR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", raising=False)
    return tmp_path, calls


# ---------------------------------------------------------------------------
# .h5
# ---------------------------------------------------------------------------


def test_craft_h5_port_writer_reads_in_jax_and_h5py(tmp_path):
    tree = _craft_tree()
    path = weights.craft_variables_to_h5(tree, str(tmp_path / "craft.h5"))
    assert_trees_identical(jweights.craft_variables_from_h5(path), tree)
    assert_trees_identical(weights.craft_variables_from_h5(path), tree)
    with h5py.File(path, "r") as f:
        assert [n.decode() for n in f.attrs["layer_names"]] == jexport._craft_layer_order()
        assert len(f) == 83 and f.attrs["backend"] == b"tensorflow"
        assert f["concatenate"].attrs["weight_names"].dtype == np.float64
        assert f["upconv2.conv.4"].attrs["weight_names"].tolist() == [
            f"upconv2.conv.4/{n}:0".encode()
            for n in ("gamma", "beta", "moving_mean", "moving_variance")]


@pytest.mark.parametrize("include_top", [True, False])
@pytest.mark.parametrize("stn", [True, False])
def test_crnn_h5_port_writer_reads_in_jax(tmp_path, include_top, stn):
    tree = _crnn_tree(stn=stn)
    path = weights.crnn_variables_to_h5(tree, str(tmp_path / "crnn.h5"), include_top=include_top)
    want = tree
    if not include_top:
        want = {"params": {k: v for k, v in tree["params"].items() if k != "fc_12"},
                "batch_stats": tree["batch_stats"]}
    assert_trees_identical(jweights.crnn_variables_from_h5(path, include_top=include_top), want)
    assert_trees_identical(weights.crnn_variables_from_h5(path, include_top=include_top), want)
    with h5py.File(path, "r") as f:
        assert ("model_2" in f) == stn
        if stn:
            assert f["model_2"].attrs["weight_names"][0] == b"conv2d/kernel:0"


def test_port_loaders_read_jax_written_files(tmp_path):
    craft, crnn = _craft_tree(seed=2), _crnn_tree(seed=3)
    craft_path = jweights.craft_variables_to_h5(craft, str(tmp_path / "craft.h5"))
    assert_trees_identical(weights.craft_variables_from_h5(craft_path),
                           jweights.craft_variables_from_h5(craft_path))
    for include_top in (True, False):
        path = jweights.crnn_variables_to_h5(crnn, str(tmp_path / f"crnn{include_top}.h5"),
                                             include_top=include_top)
        assert_trees_identical(weights.crnn_variables_from_h5(path, include_top=include_top),
                               jweights.crnn_variables_from_h5(path, include_top=include_top))


def _write_layer(group, layer_name, arrays_with_names):
    """``tests/test_weights_h5.py``'s layout: datasets at
    ``<layer>/<layer>/<name>``, ``weight_names`` a list of bytes (stored by
    h5py 3 as variable-length strings)."""
    layer = group.create_group(layer_name)
    names = []
    for name, array in arrays_with_names:
        layer.create_dataset(f"{layer_name}/{name}", data=array)
        names.append(f"{layer_name}/{name}".encode())
    layer.attrs["weight_names"] = names


def test_port_loaders_read_h5py_files_with_model_weights_and_counter_names(tmp_path):
    """``model_weights``-wrapped CRAFT and CRNN files, and an STN whose
    inner layers carry the saving process's global counters (``conv2d_9`` before
    ``conv2d_10``), read as the JAX loaders read them."""
    craft, crnn = _craft_tree(seed=4), _crnn_tree(seed=5)
    craft_path = str(tmp_path / "craft.h5")
    with h5py.File(craft_path, "w") as f:
        mw = f.create_group("model_weights")
        for ref_name, (path, kind) in weights.craft_name_map().items():
            leaf = weights._node(craft["params"], path)
            if kind == "conv":
                _write_layer(mw, ref_name, [("kernel:0", leaf["kernel"]), ("bias:0", leaf["bias"])])
            else:
                stats = weights._node(craft["batch_stats"], path)
                _write_layer(mw, ref_name, [
                    ("gamma:0", leaf["scale"]), ("beta:0", leaf["bias"]),
                    ("moving_mean:0", stats["mean"]), ("moving_variance:0", stats["var"])])
    assert_trees_identical(weights.craft_variables_from_h5(craft_path),
                           jweights.craft_variables_from_h5(craft_path))
    assert_trees_identical(weights.craft_variables_from_h5(craft_path), craft)

    params, stats = crnn["params"], crnn["batch_stats"]
    crnn_path = str(tmp_path / "crnn_counters.h5")
    with h5py.File(crnn_path, "w") as f:
        for name in weights.CRNN_CONV_LAYERS + weights.CRNN_DENSE_LAYERS:
            _write_layer(f, name, [("kernel:0", params[name]["kernel"]),
                                   ("bias:0", params[name]["bias"])])
        for name in weights.CRNN_BN_LAYERS:
            _write_layer(f, name, [
                ("gamma:0", params[name]["scale"]), ("beta:0", params[name]["bias"]),
                ("moving_mean:0", stats[name]["mean"]),
                ("moving_variance:0", stats[name]["var"])])
        for name in weights.CRNN_LSTM_LAYERS:
            _write_layer(f, name, [("kernel:0", params[name]["kernel"]),
                                   ("recurrent_kernel:0", params[name]["recurrent_kernel"]),
                                   ("bias:0", params[name]["bias"])])
        stn = params["stn"]
        _write_layer(f, "model_3", [
            (f"model_3/{inner}/{leaf}:0", stn[ours][leaf])
            for ours, inner in (("conv1", "conv2d_9"), ("conv2", "conv2d_10"),
                                ("dense1", "dense_9"), ("dense2", "dense_10"))
            for leaf in ("kernel", "bias")])
    assert_trees_identical(weights.crnn_variables_from_h5(crnn_path),
                           jweights.crnn_variables_from_h5(crnn_path))
    assert_trees_identical(weights.crnn_variables_from_h5(crnn_path), crnn)


# ---------------------------------------------------------------------------
# .pth
# ---------------------------------------------------------------------------


def _legacy_clovaai_pth(tree, path):
    """A ``.pth`` as clovaai's ``craft_mlt_25k.pth`` is stored: the legacy
    (pre-zip) format, ``module.`` keys, no ``num_batches_tracked``."""
    state = {f"module.{key}": torch.from_numpy(np.ascontiguousarray(value))
             for key, value in weights.craft_variables_to_torch_state_dict(tree).items()
             if not key.endswith("num_batches_tracked")}
    torch.save(state, path, _use_new_zipfile_serialization=False)
    return path


@pytest.mark.parametrize("writer", ["port", "jax", "legacy"])
def test_craft_pth_both_ways(tmp_path, writer):
    tree = _craft_tree(seed=6)
    path = str(tmp_path / "craft.pth")
    if writer == "port":
        weights.save_craft_torch_checkpoint(tree, path)
    elif writer == "jax":
        jweights.save_craft_torch_checkpoint(tree, path)
    else:
        _legacy_clovaai_pth(tree, path)
        with open(path, "rb") as f:
            assert f.read(2) != b"PK"  # not a zip archive
    for loader in (weights.load_torch_checkpoint, jweights.load_torch_checkpoint,
                   weights.load_craft_weights):
        assert_trees_identical(loader(path), tree)
    state = torch.load(path, map_location="cpu", weights_only=True)
    ours = weights.craft_variables_to_torch_state_dict(tree)
    theirs = jweights.craft_variables_to_torch_state_dict(tree)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype and ours[key].tobytes() == theirs[key].tobytes()
    assert all(k.startswith("module.") for k in state) == (writer == "legacy")
    with pytest.raises(NotImplementedError):
        weights.load_craft_weights(str(tmp_path / "craft.npz"))


# ---------------------------------------------------------------------------
# Lookup (tests/test_weights_sources.py's cases on the port)
# ---------------------------------------------------------------------------


@pytest.fixture()
def entry(offline):
    tmp_path, calls = offline
    payload = b"fake-weight-bytes"
    config = {
        "url": "https://unreachable.invalid/release/fake_weights.h5",
        "filename": "fake_weights.h5",
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    return config, payload, tmp_path, calls


def test_lookup_vendored_file_wins_without_network(entry):
    config, payload, tmp_path, calls = entry
    vendored = tmp_path / "vendored"
    vendored.mkdir()
    (vendored / config["filename"]).write_bytes(payload)
    assert weights.download_pretrained(config) == str(vendored / config["filename"])
    assert calls == []


def test_lookup_corrupt_vendored_file_is_not_trusted(entry):
    config, payload, tmp_path, calls = entry
    vendored = tmp_path / "vendored"
    vendored.mkdir()
    (vendored / config["filename"]).write_bytes(b"corrupted")
    with pytest.raises(RuntimeError, match="fake_weights.h5"):
        weights.download_pretrained(config)
    # The canonical URL first, then each public mirror; nothing cached.
    assert calls[0] == config["url"]
    assert len(calls) == 1 + len(weights.WEIGHT_MIRRORS)
    assert not os.listdir(tmp_path / "cache")


def test_lookup_mirror_after_canonical_failure(entry, monkeypatch):
    """The real ``download_and_verify`` streams the mirror's bytes to
    ``.partial`` and renames it into the cache."""
    config, payload, tmp_path, calls = entry

    def serve(url, timeout=None):
        calls.append(url)
        if url == config["url"]:
            raise OSError("DNS failure")
        return io.BytesIO(payload)

    monkeypatch.setattr(urllib.request, "urlopen", serve)
    path = weights.download_pretrained(config)
    assert path == str(tmp_path / "cache" / config["filename"])
    assert calls == [config["url"], weights.WEIGHT_MIRRORS[0].format(filename=config["filename"])]
    assert os.listdir(tmp_path / "cache") == [config["filename"]]
    # Cached now: the next lookup reads no URL.
    assert weights.download_pretrained(config) == path and len(calls) == 2


def test_lookup_env_mirror_first(entry, monkeypatch):
    config, payload, tmp_path, calls = entry
    monkeypatch.setenv("KERAS_OCR_TPU_WEIGHTS_MIRROR", "http://mirror.local/base/")
    with pytest.raises(RuntimeError):
        weights.download_pretrained(config)
    assert calls[:2] == ["http://mirror.local/base/" + config["filename"], config["url"]]


def test_lookup_vendor_weight_file_persists_copy(entry):
    config, payload, tmp_path, calls = entry
    source = tmp_path / "elsewhere" / config["filename"]
    source.parent.mkdir()
    source.write_bytes(payload)
    dest = weights.vendor_weight_file(str(source))
    assert dest == os.path.join(str(tmp_path / "vendored"), config["filename"])
    with open(dest, "rb") as f:
        assert f.read() == payload
    assert weights.vendor_weight_file(str(source)) == dest
    assert weights.download_pretrained(config) == dest and calls == []


def test_lookup_md5_corrupt_cache_retries_same_url(entry, monkeypatch):
    config, payload, tmp_path, calls = entry
    config = {"url": "https://unreachable.invalid/release/eff.h5", "filename": "eff.h5",
              "md5": hashlib.md5(payload).hexdigest()}
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / config["filename"]).write_bytes(b"corrupt")

    def serve(url, timeout=None):
        calls.append(url)
        return io.BytesIO(payload)

    monkeypatch.setattr(urllib.request, "urlopen", serve)
    path = weights.download_pretrained(config)
    assert path == str(cache / config["filename"])
    with open(path, "rb") as f:
        assert f.read() == payload
    assert calls == [config["url"]]  # the cached file was evicted, then fetched once


def test_safe_extract_zip_refuses_escaping_members(tmp_path):
    good = tmp_path / "good.zip"
    with zipfile.ZipFile(good, "w") as z:
        z.writestr("data/a.txt", "a")
    tools.safe_extract_zip(str(good), str(tmp_path / "out"))
    assert (tmp_path / "out" / "data" / "a.txt").read_text() == "a"
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("../escaped.txt", "x")
    with pytest.raises(ValueError, match="escapes"):
        tools.safe_extract_zip(str(bad), str(tmp_path / "out2"))
    assert not (tmp_path / "escaped.txt").exists()


def test_validate_against_names_the_mismatch():
    tree = _crnn_tree(stn=False)
    weights.validate_against(tree, tree)
    wider = {"params": dict(tree["params"], fc_12={"kernel": np.zeros((8, 5)),
                                                   "bias": np.zeros(5)}),
             "batch_stats": tree["batch_stats"]}
    with pytest.raises(ValueError, match="fc_12"):
        weights.validate_against(wider, tree)
    with pytest.raises(ValueError, match="count"):
        weights.validate_against({"params": {"conv_1": tree["params"]["conv_1"]}}, tree)
    with pytest.raises(ValueError, match="Missing"):
        weights.validate_against(tree, {"params": {}})


def test_weight_round_trips_with_h5py_and_jax_blocked(tmp_path):
    """The port's ``.h5`` and ``.pth`` writers and loaders, the twin, and
    the EfficientNet CRAFT's tree bridge and ImageNet module, with h5py,
    jax, flax, PIL, matplotlib, fontTools, tensorflow and the JAX package
    unimportable (the port's package, data modules included, imports none
    of them)."""
    code = (
        "import sys\n"
        "for name in ('h5py', 'jax', 'jaxlib', 'flax', 'PIL', 'matplotlib', 'fontTools',\n"
        "             'tensorflow', 'keras_ocr_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from keras_ocr_tpu_torch import weights\n"
        "from keras_ocr_tpu_torch.models import CRAFT, CRNN, init_parameters\n"
        "from keras_ocr_tpu_torch.detection import build_torch_model\n"
        "craft = weights.craft_variables(init_parameters(CRAFT(width=0.25), seed=0))\n"
        "crnn = weights.crnn_variables(init_parameters(CRNN(alphabet_size=5, filters=(8,) * 7,"
        " rnn_units=(8, 8)), seed=1))\n"
        "d = sys.argv[1]\n"
        "def same(a, b):\n"
        "    if isinstance(b, dict):\n"
        "        assert sorted(a) == sorted(b)\n"
        "        return all(same(a[k], b[k]) for k in b)\n"
        "    return a.tobytes() == np.ascontiguousarray(b).tobytes()\n"
        "assert same(weights.load_craft_weights(weights.craft_variables_to_h5(craft, d + "
        "'/c.h5')), craft)\n"
        "assert same(weights.load_craft_weights(weights.save_craft_torch_checkpoint(craft, d + "
        "'/c.pth')), craft)\n"
        "assert same(weights.crnn_variables_from_h5(weights.crnn_variables_to_h5(crnn, d + "
        "'/r.h5')), crnn)\n"
        "out = build_torch_model(d + '/c.pth')(torch.zeros(1, 3, 32, 32))\n"
        "from keras_ocr_tpu_torch.weights import efficientnet as imagenet\n"
        "b0 = weights.craft_variables(init_parameters(CRAFT('efficientnetb0'), seed=2))\n"
        "model = CRAFT('efficientnetb0')\n"
        "model.load_state_dict(weights.craft_state_dict(b0))\n"
        "assert same(weights.craft_variables(model), b0)\n"
        "assert same(imagenet.graft_backbone_variables(b0, {'params': b0['params']['basenet']}),"
        " b0)\n"
        "assert out.shape == (1, 2, 16, 16), out.shape\n"
        "assert not any(m.split('.')[0] in ('h5py', 'jax', 'flax', 'PIL', 'matplotlib', "
        "'fontTools', 'tensorflow', 'keras_ocr_tpu') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('round trips ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "round trips ok" in proc.stdout
