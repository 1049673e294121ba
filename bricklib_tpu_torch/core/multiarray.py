"""Host array helpers (ref: include/multiarray.h:18-41, src/multiarray.cpp).

The reference returns aligned host buffers filled by a threadprivate
mt19937_64 in (0,1); here a seeded numpy Generator.  ``uninit_array`` is
kept for API parity but returns zeros (uninitialized memory is a
C-ism with no JAX analog).

Original: ``bricklib_tpu/core/multiarray.py``.
"""

from __future__ import annotations

import numpy as np


def random_array(shape, dtype=np.float32, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random(tuple(shape), dtype=np.float64).astype(dtype)


def zero_array(shape, dtype=np.float32) -> np.ndarray:
    return np.zeros(tuple(shape), dtype=dtype)


def uninit_array(shape, dtype=np.float32) -> np.ndarray:
    return np.zeros(tuple(shape), dtype=dtype)
