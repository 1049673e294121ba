"""The cell's inputs, drawn from the seed, and the brick layout they are
read and written through.

A field is a dense float32 array of the global domain, uniform in
[-1, 1), drawn on the card by a ``torch.Generator`` seeded from the run's
seed and the field's number.  The program holds each rank's block as
brick storage; the rank's owned bricks sit where its decomposition's grid
table says (``grid[cell]`` is the storage row of brick ``cell`` of the
rank's extended brick grid).  The harness writes inputs and reads
outputs through that table, as a user of the port does; it checks first
that the table puts every owned brick in a row of its own
(:func:`owned_rows`).  The reference never sees the table.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run drawn from ``seed``."""
    h = hashlib.sha256(":".join(str(t) for t in (seed,) + tags).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def draw_field(shape, seed: int, index: int, device) -> torch.Tensor:
    """Field ``index`` of the run with ``seed``: dense, float32,
    uniform in [-1, 1), made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "field", index))
    return torch.rand(tuple(int(s) for s in shape), generator=gen,
                      device=device, dtype=torch.float32).mul_(2).sub_(1)


def owned_rows(grid: np.ndarray, gz, nbricks: int) -> np.ndarray:
    """The storage rows of the owned bricks, as ``grid`` holds them for
    the owned cells (the extended grid without ``gz`` ghost cells on each
    side), in row-major cell order; raises unless every owned brick has
    a row of its own inside the storage."""
    sl = tuple(slice(g, n - g) for g, n in zip(gz, grid.shape))
    rows = np.asarray(grid[sl]).ravel().astype(np.int64)
    if (len(np.unique(rows)) != len(rows) or rows.min() < 0
            or rows.max() >= nbricks):
        raise ValueError("the grid table does not give every owned brick "
                         "a storage row of its own")
    return rows


def _cells(dense: torch.Tensor, bdim) -> torch.Tensor:
    """``[cells, *bdim]`` blocks of ``dense`` in row-major cell order."""
    nd = len(bdim)
    g = [dense.shape[a] // bdim[a] for a in range(nd)]
    v = dense.reshape([x for a in range(nd) for x in (g[a], bdim[a])])
    v = v.permute(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
    return v.reshape((math.prod(g),) + tuple(bdim))


def to_storage(block: torch.Tensor, rows: torch.Tensor, bdim,
               nbricks: int) -> torch.Tensor:
    """Brick storage ``[nbricks, *bdim]`` of one rank's owned ``block``:
    the owned bricks at ``rows``, every other row zero (the exchange
    writes the ghosts)."""
    out = torch.zeros((nbricks,) + tuple(bdim), dtype=block.dtype,
                      device=block.device)
    out.index_copy_(0, rows, _cells(block, bdim))
    return out


def from_storage(storage: torch.Tensor, rows: torch.Tensor, bdim,
                 domain) -> torch.Tensor:
    """The dense owned block of one rank from its brick storage."""
    nd = len(bdim)
    g = [int(domain[a]) // bdim[a] for a in range(nd)]
    v = storage.index_select(0, rows).reshape(g + list(bdim))
    v = v.permute([x for a in range(nd) for x in (a, nd + a)])
    return v.reshape(tuple(int(d) for d in domain))


def rank_block(field: torch.Tensor, coords, domain) -> torch.Tensor:
    """The owned block of the rank at mesh ``coords`` in the global
    ``field``."""
    return field[tuple(slice(c * d, (c + 1) * d)
                       for c, d in zip(coords, domain))]
