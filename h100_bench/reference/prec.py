"""The precision of the reference's arithmetic, and its lower-precision
control.

The configuration states int32 DP state for the alignment kernels and
float64 for the RFA and MAPQ arithmetic (the original's Go float64).  int16
DP state is exact on these inputs (the program's range proof,
``sw_extend.int16_state_fits``), so the nearest lower precision that can
change an answer is int8.  ``LOWER`` set true is the control: the seed
extension's DP state (kernel K1's, ksw_extend2) saturates at int8's 127,
as the 8-bit first pass of striped Smith-Waterman does without its 16-bit
redo, and every power, logarithm and ratio of the RFA/MAPQ arithmetic is
rounded to float32.  Off, each function below is the float64 / exact
original.
"""

from __future__ import annotations

import math

import numpy as np

LOWER = False
INT8_MAX = 127


def f(x: float) -> float:
    """x, or x rounded to float32 under the control."""
    return float(np.float32(x)) if LOWER else x


def pow(base: float, x: float) -> float:  # noqa: A001 - math.pow's name
    if LOWER:
        return float(np.power(np.float32(base), np.float32(x), dtype=np.float32))
    return math.pow(base, x)


def log10(x: float) -> float:
    if LOWER:
        return float(np.log10(np.float32(x), dtype=np.float32))
    return math.log10(x)


def dp(x):
    """A DP state value or array, saturated at int8 under the control."""
    return np.minimum(x, INT8_MAX) if LOWER else x
