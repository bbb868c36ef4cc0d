"""Validation, random-state, checkpoint, profiling and debug-report
helpers."""

from ._show_versions import show_versions
from .checkpoint import load_estimator, save_estimator
from .random import as_generator, check_random_state
from .validation import (check_array, check_array_host,
                         check_sample_weight, check_X_y, validated_once,
                         validation_scope)

__all__ = ["as_generator", "check_array", "check_array_host",
           "check_random_state", "check_sample_weight", "check_X_y",
           "load_estimator", "save_estimator", "show_versions",
           "validated_once", "validation_scope"]
