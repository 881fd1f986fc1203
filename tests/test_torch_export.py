"""Port parity for the serving slice: the kernel ops, ``Pipeline.export``,
``load_exported`` and ``ExportedPipeline`` on the CPU.

The three ``torch.ops.keras_ocr_tpu_torch`` ops pass ``torch.library.opcheck``
on CPU tensors (``conv_layer`` in both modes). The golden slim pipeline, standard and BN-folded, is
exported at its ``pad_to`` envelope, loaded and served on golden scenes:
the loaded program's packed output must equal the live device program's
at the baked levels bit for bit, and the served words must equal the JAX
pipeline's with every box at IoU > 0.9. Ported from ``tests/test_pipeline.py``:
the slice by the artifact's own ``ctc_time``; the export against the live
refine ladder on a multi-blob scene is in
``tests/test_torch_export_multiblob.py``. One export a graph serves the
file's cases (a shared fixture), and one JAX compile the word comparison
of both graphs (the folded case after the standard one takes about half
the time it takes alone, so the two stay in one file).

The live golden pipeline against JAX's on four scenes (words equal, every
box at IoU > 0.9, the same escalation steps) is here too, on the same JAX
pipeline object, so that its compiled programs (the batch and its warp
escalation) serve both; it sat in ``tests/test_torch_pipeline.py``, which
compiled them a second time. Random weights are not used there: their
heatmaps sit on threshold knife edges. The BN-folded detector's scenes:
``tests/test_torch_pipeline_folded.py``; the port's own golden check,
``recognize_many``, the entry points and the run with JAX blocked:
``tests/test_torch_pipeline_entry.py``.
"""

import os

import numpy as np
import pytest
import torch

from keras_ocr_tpu import evaluation
from keras_ocr_tpu.utils import golden as jgolden
from keras_ocr_tpu_torch import load_exported, tools
from keras_ocr_tpu_torch.ops import cc_cuda, conv_cuda  # noqa: F401  (registers the ops)
from keras_ocr_tpu_torch.pipeline import ExportedPipeline
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SCENES = ["scene_00.png", "scene_01.png"]
# The scenes the live pipeline is held to JAX's on.
READ_SCENES = SCENES + ["scene_02.png", "scene_03.png"]
OPS = torch.ops.keras_ocr_tpu_torch


def _sweep_args(check):
    rng = np.random.RandomState(0)
    fg = rng.rand(3, 9, 13) < 0.6
    sentinel = 9 * 13
    values = np.where(fg, np.arange(sentinel).reshape(9, 13), sentinel).astype(np.int32)
    return (torch.from_numpy(values), torch.from_numpy(~fg), sentinel, 4, check)


def _keyed_args():
    values, barrier, sentinel, _, _ = _sweep_args(False)
    key = torch.from_numpy(np.random.RandomState(1).randint(0, 3, size=values.shape)).to(torch.int32)
    return (values, key, ~barrier, sentinel)


def _conv_args(k, pool, tap, chain_start):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn((2, 7, 9, 5), generator=gen)
    w = torch.randn((k, k, 5, 6), generator=gen) / (3 * k)
    return (x, w, 0.1 * torch.randn((6,), generator=gen), True, pool, tap, chain_start)


OPCHECK_CASES = {
    "cc_sweeps": (OPS.cc_sweeps.default, _sweep_args(False)),
    "cc_sweeps_check": (OPS.cc_sweeps.default, _sweep_args(True)),
    "cc_keyed_rows_cols": (OPS.cc_keyed_rows_cols.default, _keyed_args()),
    "conv_layer_3x3": (OPS.conv_layer.default, _conv_args(3, False, False, True)),
    "conv_layer_1x1_pool_tap": (OPS.conv_layer.default, _conv_args(1, True, True, False)),
    # The bf16 mode: a bf16 input with float32 weights and bias; the fake
    # kernel must give bf16 outputs, as the plain layer does.
    "conv_layer_3x3_pool_tap_bf16": (OPS.conv_layer.default, (
        _conv_args(3, True, True, True)[0].to(torch.bfloat16),
        *_conv_args(3, True, True, True)[1:])),
}


@pytest.mark.parametrize("case", list(OPCHECK_CASES))
def test_ops_pass_opcheck(case):
    """Schema, fake (meta) kernel and traced dispatch of each op agree with
    its CPU kernel (``torch.library.opcheck``)."""
    op, args = OPCHECK_CASES[case]
    torch.library.opcheck(op, args)


def test_op_cpu_kernels_are_the_plain_versions():
    values, barrier, sentinel, sweeps, _ = _sweep_args(True)
    out, converged = OPS.cc_sweeps(values, barrier, sentinel, sweeps, True)
    ref, ref_converged = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True)
    assert torch.equal(out, ref) and torch.equal(converged, ref_converged)
    assert torch.equal(OPS.cc_keyed_rows_cols(*_keyed_args()),
                       cc_cuda.keyed_rows_cols_plain(*_keyed_args()))
    x, w, b, relu, _, _, _ = _conv_args(3, True, True, True)
    out, tap = OPS.conv_layer(x, w, b, relu, True, True, True)
    ref, ref_tap = conv_cuda.conv_chain_plain(x, [(w, b, relu)], pool=True, tap_prepool=True)
    assert torch.equal(out, ref) and torch.equal(tap, ref_tap)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{graph: (live pipeline, its meta, served artifact)} for the golden
    pipeline exported at its ``pad_to`` envelope: standard at batch 2,
    folded at batch 1."""
    out = {}
    for label, fold_bn, batch_size in (("standard", False, 2), ("folded", True, 1)):
        pipeline, meta = golden.load_golden_pipeline(GOLDEN, device="cpu", fold_bn=fold_bn)
        height, width = meta["pad_to"]
        path = str(tmp_path_factory.mktemp("export") / label)
        artifact = pipeline.export(path, height=height, width=width, batch_size=batch_size,
                                   platforms=["cpu"] if fold_bn else None)
        assert artifact == path + ".pt2" and os.path.isfile(path + ".json")
        out[label] = (pipeline, meta, load_exported(path))
    return out


@pytest.fixture(scope="module")
def jax_golden():
    """JAX's golden pipeline, one object for the file: its jit keeps the
    compiled programs."""
    return jgolden.load_golden_pipeline(GOLDEN)[0]


@pytest.fixture(scope="module")
def readings(artifacts, jax_golden):
    """The golden scenes (JAX ``read``), the JAX pipeline's results, and per
    graph the served (results, diagnostics) with the packed tensor the
    loaded program returned."""
    from keras_ocr_tpu import tools as jtools

    jax_pipeline = jax_golden
    images = [jtools.read(os.path.join(GOLDEN, scene)) for scene in SCENES]
    served_out = {}
    for label, (_, _, served) in artifacts.items():
        program, packed = served._program, []
        served._program = lambda batch, program=program: packed.append(program(batch)) or packed[-1]
        try:
            scenes = images[: served.meta["batch_size"]]
            served_out[label] = (*served.recognize(scenes, return_diagnostics=True), packed[0])
        finally:
            served._program = program
    return images, [jax_pipeline.recognize([image])[0] for image in images], served_out


@pytest.mark.parametrize("graph", ["standard", "folded"])
def test_exported_golden_equals_live_and_jax(artifacts, readings, graph):
    """The loaded program's packed output equals the live device program's
    at the baked levels bit for bit; the served words equal JAX's."""
    pipeline, meta, served = artifacts[graph]
    images, ref, served_out = readings
    out, _, packed = served_out[graph]
    assert served.meta["refine_level"] == 1 and served.meta["device"] == "cpu"
    height, width = meta["pad_to"]
    batch = torch.from_numpy(np.stack([tools.pad(image, width=width, height=height)
                                       for image in images[: len(out)]]))
    live = pipeline._device_pipeline(
        batch, 0.7, 0.4, 0.4, 10.0, pipeline.detector.max_components, pipeline.max_words,
        resize_to=(height * meta["scale"], width * meta["scale"]),
        refine_level=served.meta["refine_level"], warp_level=served.meta["warp_level"],
    )
    assert torch.equal(packed, live)
    assert [[w for w, _ in r] for r in out] == [[w for w, _ in r] for r in ref[: len(out)]]
    assert all(out)
    for got, want in zip(out, ref):
        for (_, box), (_, ref_box) in zip(got, want):
            assert box.shape == (4, 2) and box.dtype == np.float32
            assert evaluation.iou_score(box, ref_box) > 0.9


def test_exported_diagnostics(readings):
    _, _, served_out = readings
    results, diags, _ = served_out["standard"]
    assert len(results) == len(diags) == 2
    for words, diag in zip(results, diags):
        assert set(diag) == {"truncated", "n_components", "converged", "refine_pending",
                             "warp_downscaled"}
        assert diag["converged"] is True and diag["refine_pending"] is False
        assert diag["warp_downscaled"] is False and diag["truncated"] is False
        assert diag["n_components"] >= len(words) > 0


def test_exported_envelope_and_platform_errors(artifacts):
    pipeline, meta, served = artifacts["standard"]
    height, width = meta["pad_to"]
    small = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="batches of 2"):
        served.recognize([small] * 3)
    with pytest.raises(ValueError, match="envelope"):
        served.recognize([np.zeros((height + 1, width, 3), np.uint8)])
    with pytest.raises(ValueError, match="platforms"):
        pipeline.export("unused", height=8, width=8, platforms=["cuda"])
    with pytest.raises(ValueError, match="platforms"):
        pipeline.export("unused", height=8, width=8, platforms=["tpu", "cpu"])


def test_exported_pipeline_slices_by_artifact_ctc_time():
    """``ExportedPipeline`` slices the decoded frames by the artifact's own
    ``ctc_time``: a fixed [9:-1] slice of a 9+T packed row would drop each
    word's last CTC frame."""
    ctc_time = 4
    meta = {"alphabet": "ab", "scale": 1, "height": 8, "width": 8, "batch_size": 1,
            "max_words": 2, "ctc_time": ctc_time}

    def make_packed(extra_cols):
        packed = np.zeros((1, 2, 9 + ctc_time + extra_cols), dtype="float32")
        packed[0, 0, 8] = 1.0  # one valid word
        packed[0, 0, :8] = [0, 0, 4, 0, 4, 4, 0, 4]
        # Greedy-decoded frames: 'a', blank, 'b', 'a'; the last 'a' sits in
        # the LAST frame, what a short slice loses.
        packed[0, 0, 9 : 9 + ctc_time] = [0, 2, 1, 0]
        if extra_cols:
            packed[0, 0, -1] = 1.0  # the component-count column
        return torch.from_numpy(packed)

    image = np.zeros((8, 8, 3), dtype="uint8")
    for extra_cols in (0, 1):  # old layout, newer layout
        served = ExportedPipeline(lambda batch, p=make_packed(extra_cols): p, meta)
        [(word, box)] = served.recognize([image])[0]
        assert word == "aba", (extra_cols, word)
        assert box.shape == (4, 2)


@pytest.fixture(scope="module")
def pipelines(jax_golden):
    return jax_golden, golden.load_golden_pipeline(GOLDEN, device="cpu")[0]


def _assert_same_reading(jax_pipeline, port_pipeline, scene):
    from keras_ocr_tpu import tools as jtools

    image = jtools.read(os.path.join(GOLDEN, scene))
    ref = jax_pipeline.recognize([image])[0]
    out = port_pipeline.recognize([image])[0]
    assert [word for word, _ in out] == [word for word, _ in ref]
    for (_, box), (_, ref_box) in zip(out, ref):
        assert box.shape == (4, 2) and box.dtype == np.float32
        assert evaluation.iou_score(box, ref_box) > 0.9
    common = set(jax_pipeline.last_run_stats) & set(port_pipeline.last_run_stats)
    assert {k: port_pipeline.last_run_stats[k] for k in common} == {
        k: jax_pipeline.last_run_stats[k] for k in common
    }


@pytest.mark.parametrize("scene", READ_SCENES)
def test_golden_scene_matches_jax_pipeline(pipelines, scene):
    _assert_same_reading(*pipelines, scene)
