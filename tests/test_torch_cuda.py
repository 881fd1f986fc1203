"""The port's CUDA sweep kernel on the card (marked ``cuda``): both entries,
the label sweeps and the keyed row/column runs, against their plain
versions.

Skipped where no CUDA device is present. On a machine with a card and no
JAX, run with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository's conftest imports JAX). The file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from keras_ocr_tpu_torch.ops import cc, cc_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(batch, height, width, seed):
    rng = np.random.RandomState(seed)
    fg = np.stack([rng.rand(height, width) < d for d in np.linspace(0.3, 0.8, batch)])
    sentinel = height * width
    values = np.where(fg, np.arange(sentinel).reshape(height, width), sentinel)
    return (
        torch.from_numpy(values.astype(np.int32)),
        torch.from_numpy((~fg).astype(np.int32)),
        sentinel,
    )


@pytest.mark.parametrize("shape", [(3, 17, 29), (2, 96, 160), (1, 5, 2500), (2, 300, 7)])
@pytest.mark.parametrize("sweeps", [0, 1, 8])
def test_kernel_equals_plain(device, shape, sweeps):
    values, barrier, sentinel = _inputs(*shape, seed=sum(shape))
    ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True)
    before = cc_cuda.segmented_min_sweeps.launches
    out, conv = cc_cuda.segmented_min_sweeps(
        values.to(device), barrier.to(device), sentinel, sweeps, True
    )
    torch.cuda.synchronize()
    assert cc_cuda.segmented_min_sweeps.launches == before + 1
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(conv.cpu(), ref_conv)


@pytest.mark.parametrize("shape", [(3, 17, 29), (2, 96, 160), (1, 5, 2500), (2, 300, 7)])
def test_keyed_kernel_equals_plain(device, shape):
    values, barrier, sentinel = _inputs(*shape, seed=sum(shape) + 1)
    fg = barrier == 0
    rng = np.random.RandomState(shape[1])
    key = torch.from_numpy(rng.randint(0, 3, size=shape).astype(np.int32))
    key = torch.where(fg, key, -1)
    ref = cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel)
    before = cc_cuda.keyed_rows_cols.launches
    out = cc_cuda.keyed_rows_cols(values.to(device), key.to(device), fg.to(device), sentinel)
    torch.cuda.synchronize()
    assert cc_cuda.keyed_rows_cols.launches == before + 1
    assert torch.equal(out.cpu(), ref)
    labels = cc.label_blobs_keyed(fg.to(device), key.to(device), num_sweeps=4)
    assert torch.equal(labels.cpu(), cc.label_blobs_keyed(fg, key, num_sweeps=4))


def test_kernel_leaves_its_input_alone_and_labels_on_device(device):
    values, barrier, sentinel = _inputs(2, 64, 96, seed=0)
    dev_values = values.to(device)
    out = cc_cuda.segmented_min_sweeps(dev_values, barrier.to(device), sentinel, 4)
    assert torch.equal(dev_values.cpu(), values)
    assert out.device.type == "cuda"
    fg = barrier == 0
    labels = cc.label_components(fg.to(device), num_sweeps=8)
    assert torch.equal(labels.cpu(), cc.label_components(fg, num_sweeps=8))


def test_kernel_rejects_what_it_cannot_take(device):
    values, barrier, sentinel = _inputs(1, 8, 8, seed=0)
    with pytest.raises(TypeError):
        cc_cuda.segmented_min_sweeps(
            values.to(device, torch.int64), barrier.to(device), sentinel, 1
        )
    with pytest.raises(ValueError):
        cc_cuda.segmented_min_sweeps(values.to(device), barrier, sentinel, 1)
