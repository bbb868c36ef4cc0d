"""Validation, random-state and checkpoint helpers."""

from .checkpoint import load_estimator, save_estimator
from .random import as_generator, check_random_state
from .validation import (check_array, check_array_host,
                         check_sample_weight, check_X_y, validated_once,
                         validation_scope)

__all__ = ["as_generator", "check_array", "check_array_host",
           "check_random_state", "check_sample_weight", "check_X_y",
           "load_estimator", "save_estimator", "validated_once",
           "validation_scope"]
