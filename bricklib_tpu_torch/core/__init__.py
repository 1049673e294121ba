"""Brick storage helpers for tensors (port of ``bricklib_tpu/core/setup.py``
and ``core/multiarray.py``).

Layout, grid tables and comparisons stay the reference's own numpy code,
imported and not copied: the port only moves data between numpy on the
host and tensors on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.core import from_bricks as _from_bricks_np
from bricklib_tpu.core import to_bricks as _to_bricks_np

__all__ = ["compare_arrays", "from_bricks", "not_ported", "random_array",
           "random_storage", "require_device", "to_bricks"]


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
