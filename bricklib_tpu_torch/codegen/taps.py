"""Stencils as the port's kernels take them: an IR, and for a linear
stencil its float32 tap table with the reference's ``params`` resolved."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..st.loader import StencilDef
from ..stencils import stencil_by_name
from .evaluate import resolve_const_from_params
from .ir import StencilIR


class TapTable(NamedTuple):
    """A linear single-input stencil as ``out = sum_t coeffs[t] *
    in[k + dk, j + dj, (i + di) % BI]``: ``offsets[t] = (dk, dj, di)`` in
    numpy axis order, int32 ``[n, 3]``; ``coeffs`` float32 ``[n]``.  Taps
    at one offset are merged, in first-seen order."""

    offsets: np.ndarray
    coeffs: np.ndarray


def as_ir(stencil) -> StencilIR:
    """A corpus name, a ``StencilDef`` or a ``StencilIR`` as an IR."""
    if isinstance(stencil, str):
        stencil = stencil_by_name(stencil)[0]
    if isinstance(stencil, StencilIR):
        return stencil
    if isinstance(stencil, StencilDef):
        return StencilIR.from_def(stencil)
    raise TypeError(f"not a stencil: {type(stencil).__name__}")


def params_from_reference(params: dict | None, stencil) -> TapTable:
    """Resolve the reference's ``params`` dict against a linear stencil's
    coefficient groups (``StencilIR.linear``) into a float32 tap table."""
    ir = as_ir(stencil)
    if ir.linear is None:
        raise ValueError("a tap table needs a linear stencil; the one "
                         f"writing {ir.sdef.output.name!r} is not")
    if len(ir.sdef.inputs) != 1:
        raise ValueError("a tap table needs a single-input stencil")
    resolve = resolve_const_from_params(dict(params or {}))
    dims = ir.dims
    merged: dict = {}
    for _key, cexpr, taps in ir.linear:
        c = (float(resolve(cexpr.name)) if hasattr(cexpr, "name")
             else float(cexpr.val))
        for sign, _grid, offs in taps:
            np_offs = tuple(int(offs[dims - 1 - a]) for a in range(dims))
            merged[np_offs] = merged.get(np_offs, 0.0) + (c if sign > 0
                                                          else -c)
    offsets = np.asarray(list(merged), np.int32).reshape(-1, dims)
    coeffs = np.asarray(list(merged.values()), np.float32)
    return TapTable(offsets, coeffs)
