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
    """A linear stencil as ``out = sum_t coeffs[t] * in_t[k + dk, j + dj,
    (i + di) % BI]``: ``offsets[t] = (dk, dj, di)`` in numpy axis order
    (one entry per axis at any rank), int32 ``[n, dims]``; ``coeffs``
    float32 ``[n]``; ``inputs`` int32 ``[n]``, the input field of each tap
    for a multi-input stencil (``None``: one input).  Taps at one (input,
    offset) are merged, in first-seen order."""

    offsets: np.ndarray
    coeffs: np.ndarray
    inputs: np.ndarray | None = None


def as_ir(stencil) -> StencilIR:
    """A corpus name, a ``StencilDef`` or a ``StencilIR`` as an IR."""
    if isinstance(stencil, str):
        stencil = stencil_by_name(stencil)[0]
    if isinstance(stencil, StencilIR):
        return stencil
    if isinstance(stencil, StencilDef):
        return StencilIR.from_def(stencil)
    raise TypeError(f"not a stencil: {type(stencil).__name__}")


def params_from_reference(params: dict | None, stencil,
                          fields: tuple | None = None) -> TapTable:
    """Resolve the reference's ``params`` dict against a linear stencil's
    coefficient groups (``StencilIR.linear``) into a float32 tap table.
    ``fields``: for a multi-input stencil, its input names in the order
    the sweep takes them (each tap's ``inputs`` entry indexes them)."""
    ir = as_ir(stencil)
    if ir.linear is None:
        raise ValueError("a tap table needs a linear stencil; the one "
                         f"writing {ir.sdef.output.name!r} is not")
    if fields is None and len(ir.sdef.inputs) != 1:
        raise ValueError("a tap table needs a single-input stencil")
    resolve = resolve_const_from_params(dict(params or {}))
    dims = ir.dims
    merged: dict = {}
    for _key, cexpr, taps in ir.linear:
        c = (float(resolve(cexpr.name)) if hasattr(cexpr, "name")
             else float(cexpr.val))
        for sign, grid, offs in taps:
            key = (fields.index(grid) if fields is not None else 0,) + tuple(
                int(offs[dims - 1 - a]) for a in range(dims))
            merged[key] = merged.get(key, 0.0) + (c if sign > 0 else -c)
    keys = np.asarray(list(merged), np.int32).reshape(-1, dims + 1)
    coeffs = np.asarray(list(merged.values()), np.float32)
    return TapTable(np.ascontiguousarray(keys[:, 1:]), coeffs,
                    None if fields is None else keys[:, 0].copy())
