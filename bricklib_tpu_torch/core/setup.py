"""Data import/export between dense arrays and bricks, and the halo-extend
block gather that replaces the reference's per-element adjacency accessor.

Reference equivalents: ``copyToBrick``/``copyFromBrick``/``iter_grid``
(include/bricksetup.h:103-221).  Where the reference walks the array and
brick side-by-side element-wise under OpenMP, the TPU version is a single
vectorized blocked transpose + scatter/gather, usable on host (numpy) or
on torch tensors.

Original: ``bricklib_tpu/core/setup.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _permute(a, perm):
    return a.permute(*perm) if torch.is_tensor(a) else np.transpose(a, perm)


def _blocks_from_dense(arr, gshape, bdims):
    """[... dense ...] -> [ncells, prod(bdims)] in row-major cell order."""
    dims = len(bdims)
    shape = []
    for g, b in zip(gshape, bdims):
        shape += [g, b]
    a = arr.reshape(shape)
    # interleaved (g0,b0,g1,b1,...) -> (g0,g1,...,b0,b1,...)
    perm = list(range(0, 2 * dims, 2)) + list(range(1, 2 * dims, 2))
    a = _permute(a, perm)
    ncells = int(np.prod(gshape))
    return a.reshape(ncells, int(np.prod(bdims)))


def _dense_from_blocks(blocks, gshape, bdims):
    dims = len(bdims)
    a = blocks.reshape(tuple(gshape) + tuple(bdims))
    perm = []
    for d in range(dims):
        perm += [d, dims + d]
    a = _permute(a, perm)
    return a.reshape(tuple(g * b for g, b in zip(gshape, bdims)))


def to_bricks(arr, grid, bdims: Sequence[int], dat=None, step: int | None = None,
              offset: int = 0):
    """Scatter a dense array into brick storage.

    ``arr`` has shape ``grid.shape * bdims`` (the caller slices out
    padding/ghost regions itself, mirroring the ``padding``/``ghost``
    arguments of the reference's copyToBrick, include/bricksetup.h:172-181).
    ``grid[cell]`` gives the destination chunk.  If ``dat`` is given
    (``[chunks, step]``), the blocks are scattered into
    ``dat[grid, offset:offset+belems]`` and the updated array is returned
    (in place); otherwise a fresh
    ``[max(grid)+1, belems]`` array is returned and ``offset`` must be 0.
    """
    grid = np.asarray(grid)
    bdims = tuple(int(b) for b in bdims)
    belems = int(np.prod(bdims))
    blocks = _blocks_from_dense(arr, grid.shape, bdims)
    idx = grid.ravel()
    if dat is None:
        assert offset == 0
        n = int(grid.max()) + 1
        if not torch.is_tensor(blocks):
            out = np.zeros((n, belems), dtype=arr.dtype)
        else:
            out = torch.zeros((n, belems), dtype=arr.dtype,
                              device=arr.device)
            idx = torch.from_numpy(idx).to(arr.device)
        out[idx] = blocks
        return out
    if isinstance(dat, np.ndarray):
        dat[idx, offset:offset + belems] = np.asarray(blocks)
        return dat
    dat[torch.from_numpy(idx).to(dat.device), offset:offset + belems] = blocks
    return dat


def from_bricks(dat, grid, bdims: Sequence[int], offset: int = 0):
    """Gather brick storage back into a dense array of shape
    ``grid.shape * bdims`` (ref copyFromBrick, include/bricksetup.h:183-221)."""
    grid = np.asarray(grid)
    bdims = tuple(int(b) for b in bdims)
    belems = int(np.prod(bdims))
    ids = grid.ravel()
    if torch.is_tensor(dat):
        ids = torch.from_numpy(ids).to(dat.device)
    blocks = dat[ids, offset:offset + belems]
    return _dense_from_blocks(blocks, grid.shape, bdims)


def halo_extend(view, adj, lo: Sequence[int], hi: Sequence[int],
                rows=None):
    """Per-brick halo-extended blocks via adjacency gathers.

    ``view`` is ``[nbricks, *bdims]``; returns ``[nrows, *(lo+bdims+hi)]``
    where the shell is filled from the 3^dims neighbors through ``adj``.
    This is the vectorized TPU replacement for the reference's per-element
    ``_BrickAccessor`` indirection (include/brick.h:214-327): one block
    gather per populated adjacency column instead of an adjacency lookup
    per element.  Reads that fall off the grid resolve to brick 0 and
    return its (garbage) contents, matching reference semantics.

    ``adj`` (and ``rows``) may be numpy arrays or, for a tensor ``view``,
    tensors on its device.  ``lo[a]``/``hi[a]`` are the halo depths (≤ bdims[a]) on the low/high
    side of axis ``a``.  ``rows`` restricts output to a brick subset (the
    drivers' interior/boundary split, cf. the reference's ``skip`` ring
    and sep_pos scheduling, weak/main.cpp:26-36, brick-mpi.h:196).
    """
    from .layout import adj_index

    if torch.is_tensor(view):
        # a tensor already on the device is used as it is (no upload)
        adj = torch.as_tensor(adj if torch.is_tensor(adj)
                              else np.asarray(adj), device=view.device).long()
        if rows is not None:
            rows = torch.as_tensor(rows if torch.is_tensor(rows)
                                   else np.asarray(rows), device=view.device)
    if rows is not None:
        adj = adj[rows]
    nb = adj.shape[0]
    bdims = view.shape[1:]
    dims = len(bdims)
    lo = tuple(int(x) for x in lo)
    hi = tuple(int(x) for x in hi)
    for a in range(dims):
        if lo[a] > bdims[a] or hi[a] > bdims[a]:
            raise ValueError("halo depth exceeds brick dim")

    eshape = tuple(l + b + h for l, b, h in zip(lo, bdims, hi))
    if torch.is_tensor(view):
        E = torch.zeros((nb,) + eshape, dtype=view.dtype, device=view.device)
    else:
        E = np.zeros((nb,) + eshape, dtype=view.dtype)

    def piece(delta):
        """source slice of neighbor-brick view, dest slice of E, per axis."""
        src, dst = [], []
        for a in range(dims):
            if delta[a] == -1:
                if lo[a] == 0:
                    return None, None
                src.append(slice(bdims[a] - lo[a], bdims[a]))
                dst.append(slice(0, lo[a]))
            elif delta[a] == 0:
                src.append(slice(0, bdims[a]))
                dst.append(slice(lo[a], lo[a] + bdims[a]))
            else:
                if hi[a] == 0:
                    return None, None
                src.append(slice(0, hi[a]))
                dst.append(slice(lo[a] + bdims[a], lo[a] + bdims[a] + hi[a]))
        return tuple(src), tuple(dst)

    def rec(a, delta):
        if a == dims:
            if all(d == 0 for d in delta):
                src = (slice(None),) * dims
                dst = tuple(slice(l, l + b) for l, b in zip(lo, bdims))
                center = view if rows is None else view[adj[:, adj_index(
                    (0,) * dims)]]
                E[(slice(None),) + dst] = center
                return
            src, dst = piece(delta)
            if src is None:
                return
            nbr = adj[:, adj_index(delta)]
            data = view[(nbr,) + src]    # gathers the halo slice alone
            E[(slice(None),) + dst] = data
            return
        for d in (-1, 0, 1):
            rec(a + 1, delta + (d,))

    rec(0, ())
    return E
