"""Port parity: ``keras_ocr_tpu_torch.config`` against ``keras_ocr_tpu.config``.

The same fields and defaults (the dtype policy in torch dtypes), ``replace``,
``get_config`` / ``set_config``, the environment variable that picks the
default compute dtype, and ``configure``'s boolean, with ``MEMORY_FRACTION``
left alone where no card is present. As in the JAX package the facades do
not read the configuration: their own default stays float32.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import pytest
import torch

from keras_ocr_tpu import config as jconfig
from keras_ocr_tpu_torch import Detector, Recognizer
from keras_ocr_tpu_torch import config

torch.set_num_threads(2)

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def test_fields_and_defaults_match_jax():
    ours, theirs = config.RuntimeConfig(), jconfig.RuntimeConfig()
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for field in dataclasses.fields(ours):
        value, reference = getattr(ours, field.name), getattr(theirs, field.name)
        assert value == DTYPES.get(reference, reference), field.name
    assert ours.compute_dtype == torch.bfloat16 and ours.param_dtype == torch.float32


def test_runtime_config_defaults_and_replace():
    cfg = config.get_config()
    assert cfg.max_components > 0
    new = cfg.replace(max_words=128)
    assert new.max_words == 128 and cfg.max_words == 256
    assert cfg is not new


def test_set_config_replaces_the_global():
    previous = config.get_config()
    try:
        custom = previous.replace(max_components=64)
        config.set_config(custom)
        assert config.get_config() is custom
    finally:
        config.set_config(previous)
    assert config.get_config() is previous


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_env_picks_the_default_compute_dtype(monkeypatch, name):
    monkeypatch.setenv("KERAS_OCR_TPU_COMPUTE_DTYPE", name)
    ours = importlib.reload(config).get_config()
    theirs = importlib.reload(jconfig).get_config()
    assert ours.compute_dtype == DTYPES[theirs.compute_dtype] == getattr(torch, name)
    monkeypatch.delenv("KERAS_OCR_TPU_COMPUTE_DTYPE")
    importlib.reload(config)
    importlib.reload(jconfig)
    assert config.get_config().compute_dtype == torch.bfloat16


def test_configure_reports_boolean(monkeypatch):
    monkeypatch.setenv("MEMORY_FRACTION", "0.5")
    assert config.configure() is torch.cuda.is_available()


def test_facades_keep_float32_whatever_the_config():
    """The JAX facades default to float32 (``keras_ocr_tpu/detection.py:239``)
    while the configuration says bfloat16; so do the port's."""
    assert config.get_config().compute_dtype == torch.bfloat16
    slim = dict(filters=(4,) * 7, rnn_units=(4, 4), stn=False, height=31, width=200,
                color=False, dropout=0.25, rnn_steps_to_discard=2, pool_size=2)
    detector = Detector(weights=None, width=0.125, device="cpu")
    recognizer = Recognizer("abc", None, slim, device="cpu")
    assert detector.model.dtype == recognizer.model.dtype == torch.float32
