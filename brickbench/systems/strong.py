"""The strong-scaling driver: ``bricklib_tpu_torch.drivers.strong``'s
step on the cell's shapes (pencil backend, SHIFT exchange: the face
rows' gathers and kernel K5, then the batched sweeps over every
subdomain of a card).  The global domain is cut into the cell's
subdomains; each rank holds a block of them in Z-Morton order as one
``[nsub, nbricks, *brick]`` stack.  A slot is one row of that stack: row
``row`` of the rank at mesh coordinates ``c`` holds the subdomain at
``c * local_block + sub_order[row]``."""

from __future__ import annotations

import contextlib
import time

import torch

from brickbench.systems import Slots


class System(Slots):
    def __init__(self, cell, device: str = "cuda"):
        from bricklib_tpu_torch.drivers.strong import build_step

        cfg = cell.config
        if cfg["skin"] != "good":
            raise ValueError("the strong driver lays its bricks out by the "
                             f"'good' skin only, not {cfg['skin']!r}")
        t0 = time.perf_counter()
        self.step, state, plan, _ = build_step(
            dom=cell.global_domain, sdom=cell.subdomain, bdim=cell.brick,
            stencil=cfg["stencil"], st_iter=int(cfg["st_iter"]),
            fuse=int(cell.traffic["fuse"]), device=device,
            mesh_shape=cell.mesh, exchange="shift", devices=None,
            backend="pencil")
        self.plan_s = time.perf_counter() - t0
        if tuple(plan.ghost_depth) != cell.ghost:
            raise ValueError(f"the program's ghost {plan.ghost_depth} is "
                             f"not the cell's {cell.ghost}")
        self.plan, self.state = plan, state
        self.single = torch.is_tensor(state)
        mesh, nsub = self.step.mesh, plan.nsub_local
        places, coords = [], []
        for r in range(mesh.size):
            c, s = mesh.place(r)
            at = mesh.coords_of(r)
            for row, sub in enumerate(plan.sub_order):
                places.append((c, s * nsub + row))
                coords.append([at[a] * plan.local_block[a] + int(sub[a])
                               for a in range(len(at))])
        self._index(cell, plan.sdec.grid, places, coords)

    def cards(self, x) -> list:
        """The one rank's stack as it is; on a mesh each card's ``[p,
        nsub, ...]`` stack as ``[p * nsub, ...]``."""
        return [x] if self.single else [t.view((-1,) + tuple(t.shape[2:]))
                                        for t in x]


@contextlib.contextmanager
def no_exchange():
    """The strong driver's SHIFT exchange replaced by one that moves
    nothing."""
    from bricklib_tpu_torch.drivers import strong

    saved = strong.strong_exchange
    strong.strong_exchange = lambda plan, axis_order=None, mesh=None: (
        lambda state: state)
    try:
        yield
    finally:
        strong.strong_exchange = saved
