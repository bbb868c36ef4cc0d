"""Validation and random-state helpers."""

from .random import as_generator, check_random_state
from .validation import (check_array, check_sample_weight, check_X_y,
                         validated_once, validation_scope)

__all__ = ["as_generator", "check_array", "check_random_state",
           "check_sample_weight", "check_X_y", "validated_once",
           "validation_scope"]
