"""One adapter per driver of the program, found by the name that a
configuration gives as its ``"driver"``: ``systems/<driver>.py``.

An adapter module holds ``System(cell, device)``, which builds the
driver's step on the cell's shapes, and ``no_exchange()``, a context in
which the driver builds its step with an exchange that moves nothing
(the fault :func:`brickbench.faults.no_exchange`).  A ``System`` is a
:class:`Slots`: the harness reads and writes the program's state through
it and nothing else.  A new driver is a new file here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fields


class Slots:
    """The program's state as slots: per card a ``[slots, nbricks,
    *brick]`` tensor (:meth:`cards`), each slot one subdomain of the
    global domain in brick storage, its owned bricks in the rows the
    decomposition's grid table gives (``rows``).

    A subclass builds ``step``, ``state`` and ``plan_s`` (the host
    seconds of the build), defines :meth:`cards` and calls
    :meth:`_index`.  Then ``places[i]`` is slot ``i``'s ``(card, index)``
    and ``coords[i]`` its place in the global domain, in subdomains per
    axis."""

    def cards(self, x) -> list:
        """Per card, the ``[slots, nbricks, *brick]`` tensor of state
        ``x``."""
        raise NotImplementedError

    def _index(self, cell, grid: np.ndarray, places: list,
               coords: list) -> None:
        """Check and keep the slots: ``grid`` the decomposition's grid
        table of one subdomain, ``places`` and ``coords`` per slot."""
        self.cell = cell
        cards = self.cards(self.state)
        self.devices = [t.device for t in cards]
        self.nbricks = int(cards[0].shape[1])
        bricks = tuple(cards[0].shape[2:])
        if bricks != cell.brick:
            raise ValueError(f"the program's bricks {bricks} are not the "
                             f"cell's {cell.brick}")
        gz = [g // b for g, b in zip(cell.ghost, cell.brick)]
        rows = fields.owned_rows(grid, gz, self.nbricks)
        self.rows = {d: torch.from_numpy(rows).to(d) for d in self.devices}
        have = sorted((c, s) for c, t in enumerate(cards)
                      for s in range(t.shape[0]))
        if sorted(places) != have or len(places) != len(coords):
            raise ValueError(f"{len(have)} slots in the state, "
                             f"{len(places)} placed")
        coords = [tuple(int(x) for x in c) for c in coords]
        if sorted(coords) != list(np.ndindex(*cell.subdomain_grid)):
            raise ValueError("the slots do not cover the subdomain grid "
                             f"{cell.subdomain_grid} exactly once")
        self.places, self.coords = list(places), coords

    def storage(self, field_: torch.Tensor) -> list:
        """The state (per card) that holds the global ``field_``: each
        slot's owned bricks, zero ghosts."""
        out = []
        for c, dev in enumerate(self.devices):
            slots = sorted((s, i) for i, (cc, s) in enumerate(self.places)
                           if cc == c)
            out.append(torch.stack([fields.to_storage(
                fields.rank_block(field_, self.coords[i],
                                  self.cell.subdomain).to(dev),
                self.rows[dev], self.cell.brick, self.nbricks)
                for _s, i in slots]))
        return out

    def block(self, cards: list, i: int) -> torch.Tensor:
        """Slot ``i``'s dense owned block from per-card storage."""
        c, s = self.places[i]
        return fields.from_storage(cards[c][s], self.rows[self.devices[c]],
                                   self.cell.brick, self.cell.subdomain)

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
