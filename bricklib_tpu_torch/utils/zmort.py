"""n-dimensional Z-Morton ordering (ref: include/zmort.h:18-105).

Used by the two-level strong-scaling decomposition to index subdomains so
that consecutive blocks of the Morton curve stay spatially compact
(ref: strong/args.cpp:36-113).

Original: ``bricklib_tpu/utils/zmort.py``.
"""

from __future__ import annotations

import numpy as np


class ZMort:
    """A position on the n-D Morton curve.

    ``ZMort(id, dims)`` decodes; ``ZMort.encode(coords)`` interleaves.
    Coordinate 0 is the *innermost* (least-significant) dimension, matching
    the reference where ``zmort[0]`` sets dim 0 (ref: include/zmort.h:50-70).
    """

    __slots__ = ("id", "dims")

    def __init__(self, id: int = 0, dims: int = 0):
        self.id = int(id)
        self.dims = int(dims)

    @staticmethod
    def encode(coords: "list[int] | tuple[int, ...]") -> "ZMort":
        dims = len(coords)
        zid = 0
        pos = 0
        coords = [int(c) for c in coords]
        rem = list(coords)
        while any(c > 0 for c in rem) or pos == 0:
            for d in range(dims):
                zid |= (rem[d] & 1) << (pos * dims + d)
                rem[d] >>= 1
            pos += 1
            if pos > 64:
                raise ValueError("coordinate too large")
        return ZMort(zid, dims)

    def __getitem__(self, d: int) -> int:
        """Extract coordinate of dimension d."""
        v = self.id >> d
        out = 0
        pos = 0
        while v:
            out |= (v & 1) << pos
            v >>= self.dims
            pos += 1
        return out

    def set(self, d: int, val: int) -> "ZMort":
        """Return a new ZMort with coordinate d replaced by val."""
        coords = [self[i] for i in range(self.dims)]
        coords[d] = val
        return ZMort.encode(coords).with_dims(self.dims)

    def with_dims(self, dims: int) -> "ZMort":
        self.dims = dims
        return self

    def coords(self) -> tuple[int, ...]:
        return tuple(self[d] for d in range(self.dims))

    def __eq__(self, o) -> bool:
        return isinstance(o, ZMort) and self.id == o.id and self.dims == o.dims

    def __hash__(self):
        return hash((self.id, self.dims))

    def __repr__(self):
        return f"ZMort(id={self.id}, coords={self.coords()})"


def zmort_ids(shape: tuple[int, ...]) -> np.ndarray:
    """Morton id for every cell of an n-D grid, vectorized.

    Returns i64 array of the given shape; ``shape`` is numpy-ordered
    (outermost first), coordinate of the *last* axis is Morton dim 0.
    """
    dims = len(shape)
    idx = np.indices(shape, dtype=np.int64)  # [dims, *shape], idx[0] = axis0
    out = np.zeros(shape, dtype=np.int64)
    maxbits = max(int(s - 1).bit_length() for s in shape) if shape else 0
    for b in range(maxbits):
        for a in range(dims):
            # numpy axis a (0 = outermost) is Morton dimension dims-1-a
            d = dims - 1 - a
            out |= ((idx[a] >> b) & 1) << (b * dims + d)
    return out
