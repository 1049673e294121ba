"""Stencil module loading and structural analysis.

The reference's vecscatter CLI ``exec``s a stencil .py and expects the
module global ``STENCIL = [assigned grids]`` (ref: codegen/vecscatter:165-168).
``load_stencil_module`` keeps that contract: it accepts a file path, an
already-imported module, or a dict of module globals, and returns a
:class:`StencilDef` — the analyzed form every executor consumes.

Reference-style files that ``from st.expr import ...`` load unchanged:
while such a file runs, the loader aliases ``st`` to this package in
``sys.modules``.  The alias ends with the file, so another eDSL in the
same process (the JAX package's, in the tests) keeps its own.

Original: ``bricklib_tpu/st/loader.py``.
"""

from __future__ import annotations

import contextlib
import sys
import types
from dataclasses import dataclass, field

from .expr import Expr
from .grid import Grid, GridRef


@contextlib.contextmanager
def _st_alias():
    """``st``, ``st.expr``, ``st.grid`` and ``st.func`` name this package's
    eDSL inside the block, and what they named before after it."""
    from .. import st as st_pkg
    from . import expr, func, grid

    names = {"st": st_pkg, "st.expr": expr, "st.grid": grid, "st.func": func}
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(names)
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


@dataclass
class StencilDef:
    """One analyzed stencil output.

    Offsets everywhere in this class are **numpy-ordered** (outermost axis
    first); the eDSL's ``Index(0)``/first-subscript is the innermost axis,
    so eDSL offset lists are reversed on the way in.
    """

    output: Grid
    rhs: Expr
    inputs: dict[str, Grid]
    taps: list[GridRef] = field(default_factory=list)
    dims: int = 0

    @staticmethod
    def from_output(out_grid: Grid) -> "StencilDef":
        if out_grid.out is None:
            raise ValueError(f"grid {out_grid.name} was never assigned")
        out_ref, rhs = out_grid.out
        inputs: dict[str, Grid] = {}
        taps: list[GridRef] = []
        for node in rhs.walk():
            if isinstance(node, GridRef):
                taps.append(node)
                if node.grid is not out_grid:
                    inputs[node.grid.name] = node.grid
        return StencilDef(output=out_grid, rhs=rhs, inputs=inputs,
                          taps=taps, dims=out_grid.dims)

    def tap_offsets_np(self) -> list[tuple[int, ...]]:
        """Distinct tap offsets, numpy-ordered."""
        seen = []
        for t in self.taps:
            o = tuple(reversed(t.offsets))
            if o not in seen:
                seen.append(o)
        return seen

    def radius(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(lo, hi) halo depth per numpy axis."""
        lo = [0] * self.dims
        hi = [0] * self.dims
        for t in self.taps:
            for d, off in enumerate(t.offsets):
                a = self.dims - 1 - d  # eDSL dim -> numpy axis
                lo[a] = max(lo[a], -off)
                hi[a] = max(hi[a], off)
        return tuple(lo), tuple(hi)


def load_stencil_module(src) -> list[StencilDef]:
    """Load stencils from a path / module / globals-dict exporting
    ``STENCIL = [assigned Grid objects]``."""
    if isinstance(src, str):
        g: dict = {"__name__": "stencil_module", "__file__": src}
        with open(src) as f:
            code = f.read()
        with _st_alias():
            exec(compile(code, src, "exec"), g)
    elif isinstance(src, types.ModuleType):
        g = vars(src)
    elif isinstance(src, dict):
        g = src
    else:
        raise TypeError(f"cannot load stencil from {type(src)}")
    if "STENCIL" not in g:
        raise ValueError("stencil module must export STENCIL = [outputs]")
    return [StencilDef.from_output(out) for out in g["STENCIL"]]
