"""Core brick data layout, TPU-native.

The reference (include/brick.h:53-395) stores the domain as fixed-size
blocks ("bricks") in one flat chunked allocation, with neighbor access
going through an explicit adjacency list instead of address arithmetic.
Its three pieces map onto TPU as:

- ``BrickStorage``  — chunked flat allocation (ref: include/brick.h:53-82)
  → a single HBM tensor ``[chunks, step]``.  The reference requires the
  chunk size to be a factor/multiple of the page size
  (ref: include/brick-mpi.h:345-346); the TPU analog is that ``step`` must
  be a multiple of the 128-lane tile so rows start lane-aligned and the
  array carries no layout padding.
- ``BrickInfo``     — per-brick adjacency of all 3^dims neighbors
  (ref: include/brick.h:96-127) → an ``i32[nbricks, 3^dims]`` gather table.
  Column ``c`` encodes the offset digits base-3, most-significant digit =
  outermost dimension; the middle column 3^dims//2 is the brick itself.
  Out-of-range neighbors point at brick 0, the garbage brick
  (ref: include/bricksetup.h:44-48).
- ``Brick``         — an accessor binding info+storage+offset
  (ref: include/brick.h:353-395).  Multiple fields interleave within one
  chunk via ``step`` and per-field ``offset`` (ref: stencils/3axis.cpp:26-28).
  Instead of the reference's per-element recursive fold accessor
  (_BrickAccessor, include/brick.h:214-327), the TPU accessor is
  *vectorized*: ``view()`` reshapes the field to ``[chunks, *bdims]`` and
  all neighbor-crossing reads are block gathers through ``BrickInfo.adj``
  (see core/setup.py:halo_extend).

The canonical TPU brick is ``(8, 8, 128)`` float32 — one (sublane, lane)
vector register tile per k-slice — the analog of the reference's VFOLD
choices per ISA (ref: stencils/cpuvfold.h:8-42).  Any bdims are supported
by the jnp paths; the Pallas fast path requires the last brick dim to be a
multiple of 128 and the second-to-last a multiple of 8 (float32).

Original: ``bricklib_tpu/core/layout.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

LANE = 128     # TPU lane count (last-dim tile)
SUBLANE = 8    # float32 sublane count (second-to-last-dim tile)
CANONICAL_BDIM = (8, 8, 128)


# ---------------------------------------------------------------------------
# Adjacency column encoding
# ---------------------------------------------------------------------------

def adj_index(offsets: Sequence[int]) -> int:
    """Column in the adjacency table for a neighbor offset vector.

    ``offsets`` is numpy-ordered (axis 0 = outermost), each in {-1, 0, 1}.
    Matches the reference's base-3 digit packing where the outermost
    dimension is the most significant digit (ref: include/bricksetup.h:30-48,
    include/brick-mpi.h:271-296).
    """
    c = 0
    for o in offsets:
        if o not in (-1, 0, 1):
            raise ValueError(f"offset out of range: {offsets}")
        c = c * 3 + (o + 1)
    return c


def adj_offsets(col: int, dims: int) -> tuple[int, ...]:
    """Inverse of :func:`adj_index`."""
    out = []
    for _ in range(dims):
        out.append(col % 3 - 1)
        col //= 3
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# BrickInfo / BrickStorage / Brick
# ---------------------------------------------------------------------------

@dataclass
class BrickInfo:
    """Adjacency table: ``adj[b, c]`` = brick index of neighbor ``c`` of
    brick ``b`` (ref: include/brick.h:96-127)."""

    adj: np.ndarray  # i32 [nbricks, 3^dims]
    dims: int

    def __post_init__(self):
        assert self.adj.ndim == 2 and self.adj.shape[1] == 3 ** self.dims

    @property
    def nbricks(self) -> int:
        return self.adj.shape[0]

    @property
    def center(self) -> int:
        return 3 ** self.dims // 2

    def check_involution(self, interior_bricks: np.ndarray) -> bool:
        """adj[adj[b][c]][N-1-c] == b for all interior bricks — the
        structural invariant every reference MPI driver asserts
        (ref: weak/main.cpp:87-94, strong/main.cpp:106-113)."""
        ncols = self.adj.shape[1]
        b = np.asarray(interior_bricks).ravel()
        for c in range(ncols):
            back = self.adj[self.adj[b, c], ncols - 1 - c]
            if not np.array_equal(back, b):
                return False
        return True


@dataclass
class BrickStorage:
    """Chunked flat allocation: ``dat[chunk, e]`` with ``step`` elements per
    chunk (ref: include/brick.h:53-82).  ``dat`` may be a numpy array (host
    setup) or a torch tensor (device-resident)."""

    dat: "np.ndarray | object"  # [chunks, step]
    step: int

    @staticmethod
    def allocate(chunks: int, step: int, dtype=np.float32) -> "BrickStorage":
        if step % LANE != 0:
            raise ValueError(
                f"step ({step}) must be a multiple of the {LANE}-lane tile "
                "(TPU analog of the reference's brick-size/pagesize "
                "divisibility, ref: include/brick-mpi.h:345-346)")
        return BrickStorage(np.zeros((chunks, step), dtype=dtype), step)

    @property
    def chunks(self) -> int:
        return self.dat.shape[0]


@dataclass
class Brick:
    """A field accessor: binds BrickInfo + BrickStorage + offset within the
    chunk (ref: include/brick.h:353-395)."""

    info: BrickInfo
    storage: BrickStorage
    offset: int
    bdims: tuple[int, ...]  # numpy-ordered, outermost first

    def __post_init__(self):
        self.bdims = tuple(int(b) for b in self.bdims)
        if len(self.bdims) != self.info.dims:
            raise ValueError("bdims rank != BrickInfo dims")
        if self.offset + self.belems > self.storage.step:
            raise ValueError("field does not fit in chunk")

    @property
    def belems(self) -> int:
        return int(np.prod(self.bdims))

    def view(self):
        """``[chunks, *bdims]`` view of this field (reshape is free —
        row-major fold within the brick)."""
        d = self.storage.dat[:, self.offset:self.offset + self.belems]
        return d.reshape((self.storage.chunks,) + self.bdims)

    def with_dat(self, dat) -> "Brick":
        """Same accessor over a new storage array (functional update)."""
        return Brick(self.info, BrickStorage(dat, self.storage.step),
                     self.offset, self.bdims)

    # -- scalar accessor twin (slow; the executable spec of the reference's
    #    _BrickAccessor fold arithmetic, include/brick.h:214-327) ----------
    def read(self, b: int, pos: Sequence[int]) -> float:
        """Read element ``pos`` of brick ``b``; ``pos`` may fall outside
        [0, bdim) by up to one brick per axis, resolving through the
        adjacency list exactly like ``bOut[b][k+1][j][i-1]`` does in the
        reference's hand-written kernels (ref: stencils/3axis.cpp:51-66)."""
        deltas = []
        local = []
        for p, s in zip(pos, self.bdims):
            d = p // s
            if d not in (-1, 0, 1):
                raise IndexError("accessor reach exceeds one brick")
            deltas.append(d)
            local.append(p - d * s)
        nb = int(self.info.adj[b, adj_index(deltas)])
        v = self.view()
        return v[(nb,) + tuple(local)]


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------

def adjacency_from_grid(grid: np.ndarray, nbricks: int | None = None) -> np.ndarray:
    """Build the full 3^dims adjacency from a brick-grid table.

    ``grid[cell] = brick index``; cells outside the table resolve to brick 0
    (the garbage brick).  Vectorized equivalent of the reference's recursive
    ``init_fill`` (ref: include/bricksetup.h:30-70) and ``_adj_populate``
    (ref: include/brick-mpi.h:271-296).
    """
    grid = np.asarray(grid)
    dims = grid.ndim
    if nbricks is None:
        nbricks = int(grid.max()) + 1
    gp = np.zeros(tuple(s + 2 for s in grid.shape), dtype=np.int32)
    gp[(slice(1, -1),) * dims] = grid
    ncols = 3 ** dims
    adj = np.zeros((nbricks, ncols), dtype=np.int32)
    flat = grid.ravel()
    for col in range(ncols):
        offs = adj_offsets(col, dims)
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(offs, grid.shape))
        adj[flat, col] = gp[sl].ravel()
    return adj


def init_grid(gdims: Sequence[int]) -> tuple[np.ndarray, BrickInfo]:
    """Dense brick grid: brick index = linear row-major cell order, full
    adjacency with out-of-range pointing at 0 (ref: include/bricksetup.h:73-90).

    Note that like the reference, brick 0 here is both a real (corner) brick
    and the target of out-of-range adjacency — harmless because corner
    bricks are ghost/padding in every driver.
    """
    gdims = tuple(int(g) for g in gdims)
    n = int(np.prod(gdims))
    grid = np.arange(n, dtype=np.int32).reshape(gdims)
    adj = adjacency_from_grid(grid, nbricks=n)
    return grid, BrickInfo(adj, len(gdims))
