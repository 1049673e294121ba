"""The pencil step's sweep schedule, shared by the weak and strong drivers
and ``api.Problem``.

After its exchange a step runs ``n`` sweeps over each card's ranks.  Every
sweep but the last is ghost-inclusive: it also updates the ghost bricks
that the next sweep reads.  The last writes the owned bricks only.  Where
no axis exchanges, every axis is periodic through the grid table, the
ghost bricks are never read, and every sweep is the owned-only one.  The
sweeps over ``p`` ranks are planned on their first use, inside the step
that needs them, under ``bricklib.plan.kernels``.
"""

from __future__ import annotations

import numpy as np

from .. import trace
from ..comm.exchange import on_card


def outer_ranges(kgrid: np.ndarray, table_axes, ghost: bool) -> dict:
    """A sweep's output-range keywords over ``kgrid``'s outer axes (2-D:
    ``y_range``; 3-D: ``k_range``, ``j_range``; 4-D: ``w_range`` too).  An
    axis in ``table_axes`` computes its owned rows; an exchanged one its
    ghost rows too if ``ghost``, else skips them."""
    nd, skip = kgrid.ndim, 0 if ghost else 1
    return {f"{'wkj'[a + 4 - nd] if nd > 2 else 'y'}_range":
            (1, kgrid.shape[a] - 1) if a in table_axes
            else (skip, kgrid.shape[a] - skip)
            for a in range(nd - 1)}


class StepSweeps:
    """The ``n`` sweeps of a step.  ``make(p, ghost)`` builds the sweep
    over ``p`` ranks of a card, ghost-inclusive if ``ghost``;
    ``exchanged``: some axis exchanges real ghost bricks.  Calling the
    object on a state (one ``[p, ...]`` tensor per card) runs the sweeps
    on each card and returns the new state."""

    def __init__(self, make, n: int, exchanged: bool):
        self.make, self.n, self.exchanged = make, int(n), bool(exchanged)
        # a ghost-inclusive sweep only where a later sweep reads the ghost
        # bricks it writes
        self.ghost = self.n > 1 and self.exchanged
        self._plans: dict = {}

    def pair(self, p: int) -> tuple:
        """``(owned, ghost)``: the owned-only and the ghost-inclusive sweep
        over ``p`` ranks (``ghost`` None where the step runs none), each
        planned once."""
        todo = [(p, g) for g in (False, True)[:1 + self.ghost]
                if (p, g) not in self._plans]
        if todo:
            with trace.span(trace.PLAN_KERNELS):
                self._plans.update({k: self.make(*k) for k in todo})
        return (self._plans[p, False],
                self._plans[p, True] if self.ghost else None)

    def order(self, p: int) -> list:
        """The step's sweeps over ``p`` ranks, in the order they run."""
        owned, ghost = self.pair(p)
        return [ghost] * (self.n - 1) + [owned] if ghost else [owned] * self.n

    def longer(self, k: int) -> "StepSweeps":
        """This schedule with ``k`` more sweeps, sharing its plans (the
        weak step without its fused exchange runs the sweep that kernel
        K11 carries as a sweep of its own)."""
        s = StepSweeps(self.make, self.n + k, self.exchanged)
        s._plans = self._plans
        return s

    def __call__(self, state: list) -> list:
        if not self.n:
            return list(state)
        out = []
        for t in state:
            owned, _ = self.pair(t.shape[0])
            d = t.view((-1,) + tuple(owned.plan.bdims))
            with on_card(t.device):
                for fn in self.order(t.shape[0]):
                    d = fn(d)
            out.append(d.view(t.shape))
        return out
