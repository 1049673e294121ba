"""Brick storage: the layout, grid tables, dense/brick copies and
comparisons (``layout``, ``setup``, ``compare``, ``multiarray``: numpy
code, on torch tensors too where it says so), and the helpers that move
storage between numpy on the host and tensors on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .compare import BRICK_TOLERANCE, compare_arrays, compare_bricks
from .layout import (CANONICAL_BDIM, LANE, SUBLANE, Brick, BrickInfo,
                     BrickStorage, adj_index, adj_offsets,
                     adjacency_from_grid, init_grid)
from .multiarray import random_array, uninit_array, zero_array
from .setup import from_bricks as _from_bricks_np
from .setup import halo_extend
from .setup import to_bricks as _to_bricks_np

__all__ = ["BRICK_TOLERANCE", "CANONICAL_BDIM", "LANE", "SUBLANE", "Brick",
           "BrickInfo", "BrickStorage", "adj_index", "adj_offsets",
           "adjacency_from_grid", "compare_arrays", "compare_bricks",
           "from_bricks", "halo_extend", "init_grid", "not_ported",
           "random_array", "random_storage", "require_device", "to_bricks",
           "uninit_array", "zero_array"]


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference feature the port does not have yet;
    ``item`` names the ROADMAP.md Queue 1 entry that brings it."""
    return NotImplementedError(
        f"{what} is not ported to bricklib_tpu_torch yet "
        f"(ROADMAP.md, Queue 1: {item})")


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Asking for CUDA where there is
    none raises: the port never drops to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def to_bricks(arr, grid, bdims, device=None) -> torch.Tensor:
    """Scatter a dense array into ``[chunks, prod(bdims)]`` brick storage
    (the reference's ``to_bricks``, run in numpy on the host).  The result
    lies on ``device``, by default the device of ``arr``."""
    if device is None:
        device = arr.device if torch.is_tensor(arr) else "cpu"
    dat = _to_bricks_np(np.ascontiguousarray(_host(arr)), np.asarray(grid),
                        bdims)
    return torch.from_numpy(dat).to(require_device(device))


def from_bricks(dat, grid, bdims) -> torch.Tensor:
    """Gather brick storage back into a dense tensor of shape
    ``grid.shape * bdims`` on the device of ``dat``."""
    host = _host(dat)
    host = np.ascontiguousarray(host.reshape(host.shape[0], -1))
    out = _from_bricks_np(host, np.asarray(grid), bdims)
    dev = dat.device if torch.is_tensor(dat) else torch.device("cpu")
    return torch.from_numpy(np.ascontiguousarray(out)).to(dev)


def random_storage(dec, seed: int, device="cpu") -> torch.Tensor:
    """``[nbricks, *bdims]`` float32 storage of a decomposition, random in
    every brick (ghosts and brick 0 too), made with numpy from ``seed``."""
    shape = (dec.nbricks,) + tuple(dec.bdims)
    return torch.from_numpy(random_array(shape, np.float32, seed)).to(
        require_device(device))
