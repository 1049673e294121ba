"""Frozen tap tables of the benchmark's stencils, one module each.

A module here is named after the stencil a configuration file names
(``"stencil"``) and holds ``TAPS``: ``(offset, coefficient)`` pairs, the
offset in array-axis order (outermost axis first), read as
``out[x] += coefficient * in[x + offset]`` on a periodic domain.  The
plain reference (:mod:`brickbench.reference`) reads only these tables; a
configuration with a new stencil adds a module here.
"""

from __future__ import annotations

import importlib


def taps(name: str) -> list[tuple[tuple[int, ...], float]]:
    """The tap table of stencil ``name``."""
    mod = importlib.import_module(f"{__name__}.{name}")
    return [(tuple(int(o) for o in off), float(c)) for off, c in mod.TAPS]
