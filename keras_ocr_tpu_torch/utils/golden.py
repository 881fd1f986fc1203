"""The committed golden artifact, run through the port.

Counterpart of ``keras_ocr_tpu/utils/golden.py``: rebuild the slim trained
pipeline from ``tests/fixtures/golden_offline/`` (``meta.json``, the two
``.npz`` checkpoints) and score how many of the expected words of each
scene it reads. No JAX involved: the checkpoints go through
:mod:`keras_ocr_tpu_torch.weights`.
"""

from __future__ import annotations

import json
import os
import typing

import torch

from .. import tools
from .. import weights as weights_lib
from ..detection import Detector
from ..pipeline import Pipeline
from ..recognition import Recognizer

META_NAME = "meta.json"
EXPECTED_NAME = "expected.json"
DETECTOR_NAME = "detector_slim.npz"
RECOGNIZER_NAME = "recognizer_slim.npz"


def artifact_available(artifact_dir: str) -> bool:
    """Whether ``artifact_dir`` holds the four files of the artifact."""
    return all(os.path.isfile(os.path.join(artifact_dir, name))
               for name in (META_NAME, EXPECTED_NAME, DETECTOR_NAME, RECOGNIZER_NAME))


def _read_json(artifact_dir, name):
    with open(os.path.join(artifact_dir, name), encoding="utf8") as f:
        return json.load(f)


def load_golden_pipeline(artifact_dir: str, compute_dtype=None, *, device=None,
                         fold_bn: bool = False):
    """(pipeline, meta) rebuilt from the committed artifact files, in the
    JAX function's argument order: ``compute_dtype`` (default float32, or
    ``torch.bfloat16``) for both models; ``fold_bn`` builds the BN-folded
    detector (the checkpoint is folded on load)."""
    compute_dtype = compute_dtype or torch.float32
    meta = _read_json(artifact_dir, META_NAME)
    detector = Detector(
        weights=None,
        width=meta["detector_width"],
        max_components=meta["max_components"],
        compute_dtype=compute_dtype,
        fold_bn=fold_bn,
        device=device,
    ).load_variables(weights_lib.read_npz(os.path.join(artifact_dir, DETECTOR_NAME)))
    recognizer = Recognizer(
        weights=None,
        alphabet=meta["alphabet"],
        build_params=dict(meta["recognizer_build_params"]),
        compute_dtype=compute_dtype,
        device=detector.device,
    ).load_variables(weights_lib.read_npz(os.path.join(artifact_dir, RECOGNIZER_NAME)))
    pipeline = Pipeline(
        detector=detector,
        recognizer=recognizer,
        scale=meta["scale"],
        pad_to=tuple(meta["pad_to"]),
        max_words=meta["max_words"],
    )
    return pipeline, meta


def _word_match_fraction(expected_words, predicted_words) -> float:
    """Fraction of expected words found (multiset semantics)."""
    remaining = list(predicted_words)
    hits = 0
    for word in expected_words:
        if word in remaining:
            remaining.remove(word)
            hits += 1
    return hits / max(len(expected_words), 1)


def run_golden_check(
    artifact_dir: str, compute_dtype=None, pipeline=None, *, device=None
) -> typing.Dict[str, typing.Any]:
    """Run the committed scenes through the pipeline and score them, in the
    JAX function's argument order; without ``pipeline`` the artifact's is
    built in ``compute_dtype`` on ``device``.

    Returns {"fraction", "n_scenes", "n_words", "pass", "per_scene"} like
    the JAX package's check, plus "run_stats", the pipeline's
    ``last_run_stats`` summed over the scenes; ``pass`` applies
    ``meta["pass_fraction"]``.
    """
    expected = _read_json(artifact_dir, EXPECTED_NAME)
    if pipeline is None:
        pipeline, meta = load_golden_pipeline(artifact_dir, compute_dtype, device=device)
    else:
        meta = _read_json(artifact_dir, META_NAME)
    per_scene = []
    total_hits = 0.0
    total_words = 0
    run_stats: typing.Dict[str, int] = {}
    for entry in expected["scenes"]:
        image = tools.read(os.path.join(artifact_dir, entry["image"]))
        predictions = pipeline.recognize([image])[0]
        for key, value in pipeline.last_run_stats.items():
            run_stats[key] = run_stats.get(key, 0) + value
        predicted_words = [word for word, _ in predictions]
        fraction = _word_match_fraction(entry["words"], predicted_words)
        per_scene.append(
            {
                "image": entry["image"],
                "fraction": round(fraction, 4),
                "predicted": predicted_words,
            }
        )
        total_hits += fraction * len(entry["words"])
        total_words += len(entry["words"])
    overall = total_hits / max(total_words, 1)
    return {
        "fraction": round(overall, 4),
        "n_scenes": len(per_scene),
        "n_words": total_words,
        "pass": overall >= meta["pass_fraction"],
        "per_scene": per_scene,
        "run_stats": run_stats,
    }
