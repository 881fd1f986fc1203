"""Tracing and per-stage timing utilities.

Counterpart of ``keras_ocr_tpu/utils/profiling.py`` on ``torch.profiler``:
:func:`trace` records the CPU and (where a card is present) CUDA activity
of a block and writes a Chrome trace (``chrome://tracing`` or Perfetto
open it; TensorBoard's profiler plugin is not needed), :func:`annotate`
names a region in such a trace, and :class:`StageTimer` accumulates host
wall-clock time per named stage.
"""

from __future__ import annotations

import contextlib
import os
import time
import typing

import numpy as np
import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (a Chrome trace) when it ends. The profiler
    is yielded, so a caller may also read its ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        yield profiler
    profiler.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall-clock timings per named stage.

    Note: CUDA work is asynchronous, so a stage is only fully accounted for
    if its outputs are synchronised (``block()``) inside the stage.
    """

    def __init__(self):
        self.records: typing.Dict[str, typing.List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(time.perf_counter() - start)

    @staticmethod
    def block(tree):
        """Wait until the tensors of a nested list / tuple / dict are
        computed: a CUDA tensor synchronises its device. Returns ``tree``."""
        devices = set()

        def visit(node):
            if isinstance(node, torch.Tensor):
                if node.device.type == "cuda":
                    devices.add(node.device)
            elif isinstance(node, dict):
                for value in node.values():
                    visit(value)
            elif isinstance(node, (list, tuple)):
                for value in node:
                    visit(value)

        visit(tree)
        for device in devices:
            torch.cuda.synchronize(device)
        return tree

    def summary(self) -> typing.Dict[str, typing.Dict[str, float]]:
        out = {}
        for name, values in self.records.items():
            arr = np.asarray(values)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1000),
                "p50_ms": float(np.median(arr) * 1000),
                "total_ms": float(arr.sum() * 1000),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, stats in self.summary().items():
            lines.append(
                f"{name:>16}: p50 {stats['p50_ms']:8.2f} ms  "
                f"mean {stats['mean_ms']:8.2f} ms  x{stats['count']}"
            )
        return "\n".join(lines)
