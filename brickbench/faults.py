"""Faults planted under the timed path, for the check's own tests: each
must make ``correct`` come out false.

``wrap`` functions replace a built :class:`~brickbench.harness.System`'s
step; :func:`no_exchange` is a context in which the program builds its
step without its ghost exchange.
"""

from __future__ import annotations

import contextlib


def unchanged(system) -> None:
    """A step that returns its state unchanged."""
    system.step = lambda x: x


def half(system) -> None:
    """A step that leaves half of every rank's owned bricks as they were."""
    step = system.step
    rows = {d: r[: len(r) // 2] for d, r in system.rows.items()}

    def broken(x):
        before = [t.index_select(1, rows[t.device]) for t in
                  system.cards(x)]
        y = step(x)
        for t, b in zip(system.cards(y), before):
            t.index_copy_(1, rows[t.device], b)
        return y

    system.step = broken


def altered(system) -> None:
    """A step whose output has one owned element of rank 0 negated."""
    step = system.step
    dev = system.devices[0]
    row = int(system.rows[dev][len(system.rows[dev]) // 3])

    def broken(x):
        y = step(x)
        t = system.cards(y)[0]
        v = t[0, row].view(-1)
        v[v.numel() // 2].neg_()
        return y

    system.step = broken


@contextlib.contextmanager
def no_exchange():
    """The program's SHIFT exchange replaced by one that moves nothing."""
    from bricklib_tpu_torch.drivers import weak

    saved = weak.EXCHANGES["shift"]
    weak.EXCHANGES["shift"] = lambda dec, mesh, table_axes=(): (
        lambda state: state)
    try:
        yield
    finally:
        weak.EXCHANGES["shift"] = saved


WRAPS = {"unchanged": unchanged, "half": half, "altered": altered}
