"""The port's HDF5 reader and writer (``keras_ocr_tpu_torch.h5``) against
h5py.

Files written by h5py at test time must read back through the port as h5py
reads them, dtype and byte order included: nested groups, groups of 100 and
400 members (several symbol-table nodes; a B-tree with an internal level),
names with ``.`` and ``:``, datasets of every integer and IEEE float size
in both byte orders from scalar to 4-D and zero-size, a compact dataset,
and attributes of every kind Keras and h5py write. Features outside the
subset raise ``NotImplementedError``. Every file the port writes must read
in h5py bit for bit.
"""

import numpy as np
import pytest

from keras_ocr_tpu_torch import h5

h5py = pytest.importorskip("h5py")

DTYPES = ["f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8"]
SHAPES = [(), (5,), (2, 3), (2, 1, 3), (1, 2, 2, 3), (0,), (0, 3)]


def _values(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype.kind == "f":
        return rng.uniform(-100, 100, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, info.max, size=shape, dtype=np.int64 if info.min < 0
                       else np.uint64).astype(dtype)


def _attributes(obj):
    obj.attrs["fixed"] = np.array([b"conv_1/kernel:0", b"conv_1/bias:0"])
    obj.attrs["fixed_scalar"] = np.bytes_(b"tensorflow")
    obj.attrs["vlen_bytes"] = [b"a", b"bcd", b""]  # h5py 3: variable-length strings
    obj.attrs["vlen_str"] = "héllo"
    obj.attrs["vlen_str_list"] = ["x", "yz"]
    obj.attrs["int_scalar"] = 3
    obj.attrs["float_scalar"] = np.float32(2.5)
    obj.attrs["big_endian"] = np.arange(4, dtype=">i2")
    obj.attrs["empty"] = np.array([])  # Keras's weight_names of a weightless layer
    obj.attrs["null"] = h5py.Empty("f4")


@pytest.fixture(scope="module")
def h5py_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "h5py.h5")
    with h5py.File(path, "w") as f:
        _attributes(f)
        f.attrs["naïve"] = np.arange(3, dtype="<f8")
        for i in range(40):  # more than the first header block holds
            f.attrs[f"many_{i:02d}"] = np.arange(i, dtype="i4")
        for i, dtype in enumerate(DTYPES):
            for order in "<>":
                group = f.create_group(f"numbers/{order.replace('<', 'le').replace('>', 'be')}"
                                       f".{dtype}")
                for j, shape in enumerate(SHAPES):
                    group.create_dataset(f"d:{j}", data=_values(np.dtype(order + dtype), shape,
                                                               seed=100 * i + j))
        layer = f.create_group("basenet.slice1.0")
        layer.attrs["weight_names"] = np.array([b"basenet.slice1.0/kernel:0"])
        layer.create_dataset("basenet.slice1.0/kernel:0", data=np.ones((3, 3, 3, 8), "f4"))
        _attributes(layer["basenet.slice1.0/kernel:0"])
        f.create_group("weightless").attrs["weight_names"] = np.array([])
        for n in (100, 400):
            for i in range(n):
                f.create_group(f"wide_{n}/member_{(i * 7919) % n:03d}")
        f.create_dataset("vlen_dataset", data=[b"q", b"rr", b""])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        compact = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32BE,
                                  h5py.h5s.create_simple((3, 4)), dcpl=dcpl)
        compact.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(12, dtype=">i4").reshape(3, 4))
    return path


def _assert_same(ours, theirs):
    if isinstance(theirs, h5py.Empty):
        assert ours == h5.Empty(theirs.dtype)
        return
    assert type(ours) is type(theirs), (ours, theirs)
    if isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        if theirs.dtype == object:
            assert ours.tolist() == theirs.tolist()
        else:
            assert ours.tobytes() == theirs.tobytes()
    elif isinstance(theirs, np.generic):
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    else:
        assert ours == theirs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["le", "be"])
def test_reader_datasets_match_h5py(h5py_file, dtype, order):
    ours = h5.File(h5py_file)
    with h5py.File(h5py_file, "r") as theirs:
        group = f"numbers/{order}.{dtype}"
        assert list(ours[group]) == list(theirs[group])
        for name in theirs[group]:
            dataset = ours[f"{group}/{name}"]
            assert isinstance(dataset, h5.Dataset)
            assert dataset.shape == theirs[group][name].shape
            _assert_same(np.asarray(dataset), np.asarray(theirs[group][name]))


@pytest.mark.parametrize("where", ["/", "basenet.slice1.0/basenet.slice1.0/kernel:0"])
def test_reader_attributes_match_h5py(h5py_file, where):
    """Fixed-length and variable-length strings, numeric scalars, a
    big-endian array, the empty float64 array, a null dataspace, a
    non-ASCII name and 40 more attributes past a continuation block."""
    ours = h5.File(h5py_file)[where]
    with h5py.File(h5py_file, "r") as f:
        theirs = f[where].attrs
        assert list(ours.attrs) == sorted(theirs)
        for name in theirs:
            _assert_same(ours.attrs[name], theirs[name])
    assert ours.attrs.get("missing") is None


def test_reader_structure_matches_h5py(h5py_file):
    """Member names in name order, ``a/b/c`` paths, ``in``, iteration over
    several symbol-table nodes and an internal B-tree level, ``visititems``,
    a variable-length string dataset and a compact one."""
    ours = h5.File(h5py_file)
    with h5py.File(h5py_file, "r") as theirs:
        assert list(ours) == list(theirs) and len(ours) == len(theirs)
        for n in (100, 400):
            assert list(ours[f"wide_{n}"]) == list(theirs[f"wide_{n}"])
            assert len(ours[f"wide_{n}"]) == n
        assert ours["wide_400/member_399"].name == "/wide_400/member_399"
        seen_ours, seen_theirs = [], []
        ours["numbers"].visititems(lambda name, node: seen_ours.append(
            (name, isinstance(node, h5.Dataset))))
        theirs["numbers"].visititems(lambda name, node: seen_theirs.append(
            (name, isinstance(node, h5py.Dataset))))
        assert seen_ours == seen_theirs
        for name in ("vlen_dataset", "compact"):
            _assert_same(np.asarray(ours[name]), theirs[name][()])
        _assert_same(ours["weightless"].attrs["weight_names"],
                     theirs["weightless"].attrs["weight_names"])
    assert "basenet.slice1.0/basenet.slice1.0/kernel:0" in ours
    assert "basenet.slice1.0/missing" not in ours and "numbers/le.f4/d:0/x" not in ours
    with pytest.raises(KeyError):
        ours["missing"]


def _chunked(f):
    f.create_dataset("x", data=np.arange(10.0), chunks=(5,))


def _filtered(f):
    f.create_dataset("x", data=np.arange(100.0), compression="gzip")


def _soft_link(f):
    f.create_group("target")
    f["x"] = h5py.SoftLink("/target")


def _tracked_order(f):
    f.create_group("x", track_order=True)  # a version-2 object header


@pytest.mark.parametrize("make", [_chunked, _filtered, _soft_link, _tracked_order, "latest"])
def test_reader_refuses_unsupported_features(tmp_path, make):
    path = str(tmp_path / "unsupported.h5")
    if make == "latest":  # superblock 3, version-2 object headers
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("x", data=np.arange(3))
    else:
        with h5py.File(path, "w") as f:
            make(f)
    with pytest.raises(NotImplementedError, match="HDF5"):
        np.asarray(h5.File(path)["x"])


def test_writer_files_read_in_h5py_bit_for_bit(tmp_path):
    """Keras's root attributes, weightless groups, float32 datasets at
    ``layer/.../name:0`` paths (intermediate groups made), other dtypes and
    byte orders, a zero-size dataset, and a group of 300 members (more
    symbol-table nodes than h5py's default B-tree node holds)."""
    path = str(tmp_path / "ours.h5")
    rng = np.random.RandomState(0)
    arrays = {
        "conv_1/conv_1/kernel:0": rng.randn(3, 3, 1, 8).astype(np.float32),
        "conv_1/conv_1/bias:0": rng.randn(8).astype(np.float32),
        "lstm_10/lstm_10/lstm_cell/kernel:0": rng.randn(4, 16).astype(np.float32),
        "misc/big_endian": np.arange(6, dtype=">f8").reshape(2, 3),
        "misc/int16": np.arange(-3, 3, dtype="<i2"),
        "misc/uint8": np.arange(250, 256, dtype="u1"),
        "misc/zero": np.zeros((0, 4), np.float32),
        "misc/scalar": np.float32(7.5),
        "misc/strings": np.array([b"ab", b"c"]),
    }
    with h5.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([b"conv_1", b"lstm_10", b"dropout"])
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.15.0")
        f.create_group("dropout").attrs["weight_names"] = np.array([])
        for layer in ("conv_1", "lstm_10"):
            names = [key.split("/", 1)[1] for key in arrays if key.startswith(layer + "/")]
            group = f.create_group(layer)
            group.attrs["weight_names"] = np.array([n.encode() for n in names])
            for name in names:
                group.create_dataset(name, data=arrays[f"{layer}/{name}"])
        for key in arrays:
            if key.startswith("misc/"):
                f.create_dataset(key, data=arrays[key]).attrs["index"] = np.int64(len(key))
        for i in range(300):
            f.create_group(f"wide/m{i:03d}")
    ours = h5.File(path)
    with h5py.File(path, "r") as theirs:
        assert list(theirs) == list(ours) == ["conv_1", "dropout", "lstm_10", "misc", "wide"]
        for name in ("layer_names", "backend", "keras_version"):
            _assert_same(theirs.attrs[name], f_attr := ours.attrs[name])
            assert f_attr.dtype.kind == "S"
        _assert_same(theirs["dropout"].attrs["weight_names"], np.array([]))
        assert theirs["conv_1"].attrs["weight_names"].tolist() == [
            b"conv_1/kernel:0", b"conv_1/bias:0"]
        for key, value in arrays.items():
            _assert_same(theirs[key][()], value[()] if value.ndim == 0 else value)
            _assert_same(np.asarray(ours[key]), np.asarray(value))
            if key.startswith("misc/"):
                _assert_same(theirs[key].attrs["index"], np.int64(len(key)))
        assert list(theirs["wide"]) == list(ours["wide"]) == [f"m{i:03d}" for i in range(300)]
    with pytest.raises(TypeError):
        with h5.File(str(tmp_path / "bad.h5"), "w") as f:
            f.attrs["text"] = np.array(["unicode"])
