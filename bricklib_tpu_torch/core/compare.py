"""Comparison with the reference's tolerance contract.

BRICK_TOLERANCE mirrors include/cmpconst.h:9; a pair matches if the
absolute difference or the relative difference is below tolerance
(ref: include/brickcompare.h:30-57).  The reference computes in double;
on TPU float32 is the native element type, so comparisons are
dtype-aware: float64 keeps 1e-6, float32 uses a looser default scaled to
its epsilon.

Original: ``bricklib_tpu/core/compare.py``.
"""

from __future__ import annotations

import numpy as np

BRICK_TOLERANCE = 1e-6
F32_TOLERANCE = 5e-5


def _tol(dtype, tolerance):
    if tolerance is not None:
        return tolerance
    return BRICK_TOLERANCE if np.dtype(dtype).itemsize >= 8 else F32_TOLERANCE


def compare_arrays(a, b, tolerance: float | None = None) -> bool:
    """Elementwise abs-or-rel compare (ref: src/multiarray.cpp compareArray /
    include/brickcompare.h:30-57)."""
    a = np.asarray(a)
    b = np.asarray(b)
    tol = _tol(np.result_type(a.dtype, b.dtype), tolerance)
    diff = np.abs(a - b)
    denom = np.maximum(np.abs(a), np.abs(b))
    ok = (diff < tol) | (diff / np.maximum(denom, 1e-300) < tol)
    return bool(ok.all())


def max_mismatch(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-300)
    return float(np.minimum(diff, rel).max(initial=0.0))


def compare_bricks(dat_a, dat_b, grid, bdims, offset_a: int = 0,
                   offset_b: int = 0, tolerance: float | None = None) -> bool:
    """Compare two brick fields over the cells named by ``grid``
    (ref: include/brickcompare.h:14-57).  The caller restricts ``grid`` to
    the validated region (the reference passes dimlist/ghost for the same
    purpose)."""
    from .setup import from_bricks

    a = from_bricks(np.asarray(dat_a), grid, bdims, offset_a)
    b = from_bricks(np.asarray(dat_b), grid, bdims, offset_b)
    return compare_arrays(a, b, tolerance)
