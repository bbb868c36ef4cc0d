"""Validation and random-state helpers."""

from .random import as_generator
from .validation import (check_array, check_sample_weight, validated_once,
                         validation_scope)

__all__ = ["as_generator", "check_array", "check_sample_weight",
           "validated_once", "validation_scope"]
