"""The high-level driver: ``bricklib_tpu_torch.api.Problem`` on the cell's
shapes, one rank on one card (on the CPU, the kernels' plain versions),
stepped through its public ``advance``.  The traffic names the backend;
``"mxu"`` holds the state in flat-pencil storage ``[1, nbricks, BK,
BJ*BI]``, which the harness reads as ``[1, nbricks, BK, BJ, BI]`` views.
The one slot is the whole domain; on one rank every axis is periodic
through the grid table and nothing is exchanged."""

from __future__ import annotations

import contextlib
import time

from brickbench.systems import Slots


class System(Slots):
    def __init__(self, cell, device: str = "cuda"):
        from bricklib_tpu_torch.api import Problem

        if not hasattr(Problem, "advance"):
            raise NotImplementedError("Problem has no public step of a "
                                      "caller's state (advance)")
        cfg, traffic = cell.config, cell.traffic
        if cfg["skin"] != "good":
            raise ValueError("Problem lays its bricks out by the 'good' "
                             f"skin only, not {cfg['skin']!r}")
        if cell.ranks != 1:
            raise ValueError(f"one rank a cell, not the mesh {cell.mesh}")
        t0 = time.perf_counter()
        self.problem = p = Problem(
            dims=cell.domain, stencil=cfg["stencil"],
            st_iter=int(cfg["st_iter"]), backend=traffic["backend"],
            device=device)
        p.init(seed=0)
        self.plan_s = time.perf_counter() - t0
        d = p.describe()
        got = (d["backend"], d["fuse"], tuple(p.ghost))
        want = (traffic["backend"], int(traffic["fuse"]), cell.ghost)
        if got != want:
            raise ValueError(f"the program's (backend, fuse, ghost) {got} "
                             f"are not the cell's {want}")
        self.step = p.advance
        self.state = p.state
        self._index(cell, p.dec.grid, [(0, 0)], [(0,) * len(cell.domain)])

    def cards(self, x) -> list:
        """The one field's per-card tensors as ``[ranks, nbricks,
        *brick]`` views."""
        return [t.view(tuple(t.shape[:2]) + self.cell.brick) for t in x[0]]


@contextlib.contextmanager
def no_exchange():
    """``Problem`` builds its sweeps on the decomposition's own grid table
    in place of the periodic one: the ghost bricks are read as stored and
    never refreshed, as where an exchange moves nothing."""
    from bricklib_tpu_torch.comm.decomp import BrickDecomp

    saved = BrickDecomp.periodic_grid
    BrickDecomp.periodic_grid = lambda self, axes: self.grid.copy()
    try:
        yield
    finally:
        BrickDecomp.periodic_grid = saved
