"""Port parity: ``keras_ocr_tpu_torch.utils.profiling`` against the JAX
package's ``utils/profiling.py``: ``StageTimer`` counts and reports stages
as the JAX timer does (the same summary keys), ``block`` returns what it is
given, ``trace`` writes a Chrome trace in which ``annotate``'s region
appears.
"""

import json
import os

import jax.numpy as jnp
import torch

from keras_ocr_tpu.utils import StageTimer as JaxStageTimer
from keras_ocr_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _stages(timer, block):
    with timer.stage("detect"):
        block()
    with timer.stage("detect"):
        pass
    with timer.stage("recognize"):
        pass
    return timer.summary()


def test_stage_timer_matches_jax():
    ours = _stages(profiling.StageTimer(),
                   lambda: profiling.StageTimer.block({"x": [torch.ones(4, 4) * 2]}))
    theirs = _stages(JaxStageTimer(), lambda: JaxStageTimer.block(jnp.ones((4, 4)) * 2))
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert ours[name].keys() == theirs[name].keys()
        assert ours[name]["count"] == theirs[name]["count"]
    assert ours["detect"]["count"] == 2 and ours["recognize"]["count"] == 1


def test_report_names_every_stage():
    timer = profiling.StageTimer()
    _stages(timer, lambda: None)
    report = timer.report()
    assert "detect" in report and "recognize" in report and "x2" in report


def test_block_returns_its_tree():
    tree = {"a": torch.ones(2), "b": (torch.zeros(3), [torch.arange(4)]), "c": 1.5}
    assert profiling.StageTimer.block(tree) is tree


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    with profiling.trace(log_dir) as profiler:
        with profiling.annotate("craft_forward"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, profiling.TRACE_NAME), encoding="utf8") as f:
        events = json.load(f)["traceEvents"]
    assert any(event.get("name") == "craft_forward" for event in events)
    assert any(item.key == "craft_forward" for item in profiler.key_averages())
