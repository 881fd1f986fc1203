"""Runtime configuration of the port.

Counterpart of ``keras_ocr_tpu/config.py``: the same :class:`RuntimeConfig`
fields and defaults (the dtype policy, static capacities and size
buckets), :func:`get_config` / :func:`set_config`, the same environment
variable for the default compute dtype, and :func:`configure`.

As in the JAX package, the configuration documents the policy and the
facades do not read it: ``Detector``, ``Recognizer`` and
``detection.build_model`` default to float32 and take ``compute_dtype``
as an argument.

The JAX module's ``enable_compile_cache`` and ``_host_fingerprint`` have no
counterpart: they key and place XLA's persistent compilation cache, and the
port compiles nothing through XLA (its CUDA kernels are built by
:mod:`.kernels`, once per source, into ``build/kernels/``).

Environment variables:
    KERAS_OCR_TPU_COMPUTE_DTYPE: "bfloat16" (default) or "float32".
    MEMORY_FRACTION: forwarded by :func:`configure` to
        ``torch.cuda.set_per_process_memory_fraction``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class RuntimeConfig:
    """Global knobs of the OCR graphs.

    Attributes:
        compute_dtype: dtype of the convolutions and matmuls: bfloat16 for
            the card's tensor cores, float32 for bit parity.
        param_dtype: dtype the parameters are stored in.
        max_components: static upper bound on connected components per
            heatmap on the device ``get_boxes``.
        max_words: static upper bound on word boxes (and recognizer crops)
            per image.
        size_buckets: multiple-of used when bucketing padded image sizes.
    """

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    max_components: int = 256
    max_words: int = 256
    size_buckets: int = 256

    def replace(self, **kwargs) -> "RuntimeConfig":
        return dataclasses.replace(self, **kwargs)


def _default_config() -> RuntimeConfig:
    dtype_name = os.environ.get("KERAS_OCR_TPU_COMPUTE_DTYPE", "bfloat16")
    return RuntimeConfig(compute_dtype=COMPUTE_DTYPES[dtype_name])


_CONFIG = _default_config()


def get_config() -> RuntimeConfig:
    return _CONFIG


def set_config(config: RuntimeConfig) -> None:
    global _CONFIG
    _CONFIG = config


def configure() -> bool:
    """Configure the accelerator runtime; returns True if a CUDA card is
    present. ``MEMORY_FRACTION``, where set, caps this process's share of
    every card's memory (``torch.cuda.set_per_process_memory_fraction``),
    as the JAX function forwards it to XLA's allocator."""
    if not torch.cuda.is_available():
        return False
    memory_fraction = os.environ.get("MEMORY_FRACTION")
    if memory_fraction is not None:
        for index in range(torch.cuda.device_count()):
            torch.cuda.set_per_process_memory_fraction(float(memory_fraction), index)
    return True
