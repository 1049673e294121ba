"""The weak-scaling driver: ``bricklib_tpu_torch.drivers.weak``'s step
on the cell's shapes (pencil backend, SHIFT exchange, real ghost bricks
on every exchanged axis), one rank a card (on the CPU every rank on the
CPU, the kernels' plain versions).  A slot is a rank; rank ``r`` sits at
``np.unravel_index(r, mesh)`` of the global domain."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from brickbench.systems import Slots


class System(Slots):
    def __init__(self, cell, device: str = "cuda"):
        from bricklib_tpu_torch.drivers.weak import build_step

        cfg = cell.config
        t0 = time.perf_counter()
        self.step, state, self.dec = build_step(
            dims=cell.domain, bdim=cell.brick, stencil=cfg["stencil"],
            st_iter=int(cfg["st_iter"]), fuse=int(cell.traffic["fuse"]),
            table_periodic=False, skin=cfg["skin"], device=device,
            mesh_shape=cell.mesh, exchange="shift", devices=None,
            backend="pencil")
        self.plan_s = time.perf_counter() - t0
        self.state = state
        self.single = torch.is_tensor(state)
        # (card, slot) of each rank in ravel order: the cards in order,
        # each holding its ranks in order
        places = [(c, s) for c, t in enumerate(self.cards(state))
                  for s in range(t.shape[0])]
        if len(places) != cell.ranks:
            raise ValueError(f"{len(places)} ranks in the state, the mesh "
                             f"has {cell.ranks}")
        self._index(cell, self.dec.grid, places,
                    [np.unravel_index(r, cell.mesh)
                     for r in range(cell.ranks)])

    def cards(self, x) -> list:
        return [x.unsqueeze(0)] if self.single else list(x)


@contextlib.contextmanager
def no_exchange():
    """The weak driver's SHIFT exchange replaced by one that moves
    nothing."""
    from bricklib_tpu_torch.drivers import weak

    saved = weak.EXCHANGES["shift"]
    weak.EXCHANGES["shift"] = lambda dec, mesh, table_axes=(): (
        lambda state: state)
    try:
        yield
    finally:
        weak.EXCHANGES["shift"] = saved
