"""Validation, random-state, checkpoint, profiling and debug-report
helpers."""

from ._show_versions import show_versions
from .checkpoint import (load_estimator, load_pytree, load_stream_state,
                         save_estimator, save_pytree, save_stream_state)
from .random import as_generator, check_random_state
from .validation import (check_array, check_array_host,
                         check_sample_weight, check_X_y, validated_once,
                         validation_scope)

__all__ = ["as_generator", "check_array", "check_array_host",
           "check_random_state", "check_sample_weight", "check_X_y",
           "load_estimator", "load_pytree", "load_stream_state",
           "save_estimator", "save_pytree", "save_stream_state",
           "show_versions", "validated_once", "validation_scope"]
