"""Utilities of the port: profiling, tracing, timing (``golden`` is
imported on its own, as in the JAX package)."""

from . import profiling
from .profiling import StageTimer, annotate, trace

__all__ = ["StageTimer", "annotate", "profiling", "trace"]
