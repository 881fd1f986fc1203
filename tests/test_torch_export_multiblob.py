"""Port parity for the serving slice on a multi-blob scene, ported from
``tests/test_pipeline.py``: an export reproduces the live refine ladder
(CRAFT stood in by fixed heatmaps) with clean diagnostics.
"""

import os
import string
import sys

import numpy as np
import torch

from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, load_exported
from keras_ocr_tpu_torch.utils import golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_offline")


class _FixedCraft(torch.nn.Module):
    """A CRAFT stand-in returning fixed (H/2, W/2, 2) heatmaps."""

    def __init__(self, heatmaps):
        super().__init__()
        self.register_buffer("heatmaps", torch.from_numpy(heatmaps))

    def forward(self, x):
        return self.heatmaps[None].expand((x.shape[0],) + self.heatmaps.shape)


def test_export_matches_live_on_multiblob_scene(tmp_path):
    """The artifact's default refine level reproduces the live pipeline's
    refine ladder on multi-blob components, with clean diagnostics."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_refine import _multiblob_heatmap

    hm = _multiblob_heatmap(np.random.RandomState(5), n_words=2)
    detector = Detector(weights=None, width=0.25, max_components=16, device="cpu")
    detector.model = _FixedCraft(hm)
    recognizer = Recognizer(weights=None, alphabet=string.digits + string.ascii_lowercase,
                            build_params=golden._read_json(GOLDEN, golden.META_NAME)
                            ["recognizer_build_params"], device="cpu")
    image_height, image_width = hm.shape[0] * 2, hm.shape[1] * 2
    pipeline = Pipeline(detector=detector, recognizer=recognizer, scale=1, max_words=8,
                        pad_to=(image_height, image_width))
    image = np.zeros((image_height, image_width, 3), dtype="uint8")

    live = pipeline.recognize(images=[image])[0]
    assert pipeline.last_run_stats["refine_escalations"] >= 1
    assert len(live) >= 2

    path = str(tmp_path / "ocr_multiblob")
    pipeline.export(path, height=image_height, width=image_width)
    exported, diags = load_exported(path).recognize([image], return_diagnostics=True)
    exported = exported[0]
    assert [w for w, _ in exported] == [w for w, _ in live]
    for (_, box_a), (_, box_b) in zip(exported, live):
        np.testing.assert_allclose(box_a, box_b, atol=1e-4)
    assert diags[0]["refine_pending"] is False
    assert diags[0]["warp_downscaled"] is False
    assert diags[0]["converged"] is True
    assert diags[0]["truncated"] is False
    assert diags[0]["n_components"] >= 2
