"""numpy and PyTorch executors — the reference-semantics backends (the
torch oracle).

- ``dense_apply``: plain shifted-slice stencil on dense arrays.  This is
  the validation twin of every driver (the reference's array kernels, e.g.
  stencils/3axis.cpp arr_func, stencils/fake.h ST_CPU).
- ``brick_apply``: stencil over brick storage via the halo-extend block
  gather — the "scalar backend" analog (codegen/st/codegen/backend/scalar.py):
  numerically exact oracle for the Pallas backend, and itself jittable.

Both run on numpy arrays or on torch tensors, on the tensors' device:
numpy in, numpy out; tensor in, tensor out (``xp`` defaults to the
inputs' namespace).  The numpy form is the dense validation twin of the
drivers.  ``brick_apply`` takes ``adj`` (and ``rows``) as numpy arrays or
as tensors on the storage's device, so a caller that steps many times
uploads them once.

Original: ``bricklib_tpu/codegen/jnp_backend.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.setup import halo_extend
from ..st.loader import StencilDef
from .evaluate import evaluate, resolve_const_from_params
from .ir import StencilIR


def _as_ir(s) -> StencilIR:
    if isinstance(s, StencilIR):
        return s
    if isinstance(s, StencilDef):
        return StencilIR.from_def(s)
    raise TypeError(type(s))


def _run(ir: StencilIR, read_tap, resolve, xp):
    """Shared execution: coefficient-grouped linear path when possible
    (one multiply per coefficient group); otherwise the generic
    evaluator with memoized reads/shared subtrees and the nonlinear
    coefficient grouping of :func:`.ir.additive_groups` (the analog of
    the reference's Reduction grouping for non-linear summands)."""
    if ir.linear is not None:
        out = None
        for _key, cexpr, taps in ir.linear:
            coeff = evaluate(cexpr, read_tap, resolve, xp)
            acc = None
            for sign, gname, offs in taps:
                v = read_tap(gname, offs)
                v = -v if sign < 0 else v
                acc = v if acc is None else acc + v
            term = coeff * acc
            out = term if out is None else out + term
        return out
    from .ir import additive_groups

    groups = additive_groups(ir.sdef.rhs)
    if groups is None:
        return evaluate(ir.sdef.rhs, read_tap, resolve, xp)
    cache: dict = {}      # taps + shared subtrees memoized ACROSS groups
    out = None
    for cexpr, subs in groups:
        coeff = evaluate(cexpr, read_tap, resolve, xp, cache=cache)
        acc = None
        for sign, sub in subs:
            v = evaluate(sub, read_tap, resolve, xp, cache=cache)
            v = -v if sign < 0 else v
            acc = v if acc is None else acc + v
        term = acc if (isinstance(coeff, float) and coeff == 1.0) \
            else coeff * acc
        out = term if out is None else out + term
    return out


def _namespace(arrays):
    """``torch`` when the arrays are tensors, else numpy."""
    return torch if any(torch.is_tensor(a) for a in arrays) else np


def _np_offsets(offsets_edsl, dims):
    """eDSL offsets (dim 0 = innermost) -> numpy-axis offsets."""
    return tuple(offsets_edsl[dims - 1 - a] for a in range(dims))


def dense_apply(stencil, inputs: dict, params: dict | None = None, xp=None):
    """Apply a stencil to dense arrays; returns the valid region
    ``arr[lo_0 : S_0 - hi_0, ...]`` (the caller owns ghost bookkeeping,
    like the reference's _TILEFOR over the interior, stencils/stencils.h:19-26).
    """
    ir = _as_ir(stencil)
    if xp is None:
        xp = _namespace(inputs.values())
    params = params or {}
    dims = ir.dims
    lo, hi = ir.radius()
    shapes = {a.shape for a in inputs.values()}
    if len(shapes) != 1:
        raise ValueError("all dense inputs must share a shape")
    S = shapes.pop()

    def read_tap(name, offs_edsl):
        offs = _np_offsets(offs_edsl, dims)
        sl = tuple(slice(lo[a] + offs[a], S[a] - hi[a] + offs[a])
                   for a in range(dims))
        return inputs[name][sl]

    return _run(ir, read_tap, resolve_const_from_params(params), xp)


def brick_apply(stencil, views: dict, adj, params: dict | None = None,
                xp=None, rows=None):
    """Apply a stencil to brick fields.

    ``views[name]`` is ``[nbricks, *bdims]``; returns the output view of
    the same shape, computed for every brick (bricks whose halo reaches
    off-grid read the garbage brick, exactly like the reference accessor).
    ``rows`` restricts computation to a brick subset and returns
    ``[len(rows), *bdims]`` — used for the interior/boundary split that
    overlaps exchange with interior compute (ref: sep_pos scheduling,
    include/brick-mpi.h:196; weak/main.cu:251-291).
    """
    ir = _as_ir(stencil)
    if xp is None:
        xp = _namespace(views.values())
    params = params or {}
    dims = ir.dims
    lo, hi = ir.radius()
    bdims = next(iter(views.values())).shape[1:]

    ext = {name: halo_extend(v, adj, lo, hi, rows=rows)
           for name, v in views.items()}

    def read_tap(name, offs_edsl):
        offs = _np_offsets(offs_edsl, dims)
        sl = tuple(slice(lo[a] + offs[a], lo[a] + offs[a] + bdims[a])
                   for a in range(dims))
        return ext[name][(slice(None),) + sl]

    return _run(ir, read_tap, resolve_const_from_params(params), xp)


def offset_stack(a, count: int, stride: int) -> np.ndarray:
    """``count`` copies of brick ids ``a`` (an adjacency ``[n, 3^d]`` or a
    list of rows) stacked along the first axis, copy ``s`` offset by ``s *
    stride``: the ids of ``count`` storages stacked along the brick axis,
    each reading its own bricks (its off-grid reads its own brick 0), so
    one ``brick_apply`` runs them all."""
    a = np.asarray(a, np.int64)
    base = np.arange(int(count), dtype=np.int64) * int(stride)
    return (a[None] + base.reshape((-1,) + (1,) * a.ndim)).reshape(
        (-1,) + a.shape[1:])


class CardTables:
    """Brick id tables (an adjacency, row lists) of one storage of
    ``stride`` bricks, stacked for ``count`` storages on a card with
    :func:`offset_stack` and uploaded once per (device, count)."""

    def __init__(self, stride: int, **tables):
        self.stride, self.tables, self._cache = stride, tables, {}

    def __call__(self, device, count: int) -> dict:
        key = (device, count)
        if key not in self._cache:
            self._cache[key] = {
                k: torch.from_numpy(offset_stack(a, count, self.stride)).to(
                    device) for k, a in self.tables.items()}
        return self._cache[key]


def oracle_iterate(sdefs, fields, views, adj, params, iters: int,
                   aux: dict | None = None, owned=None) -> list:
    """``iters`` ghost-inclusive ``brick_apply`` iterations of the stencils
    ``sdefs`` (one per field of ``fields``, each view ``[nbricks,
    *bdims]``), ``aux`` read-only fields by name; with ``owned`` (row ids),
    the last iteration computes those bricks only and writes them into its
    views in place, the others keeping their values (ref: api.py:657-676).
    Returns the fields' new views."""
    views = list(views)
    for it in range(iters):
        vs = dict(aux or {})
        vs.update(zip(fields, views))
        ins = [{n: vs[n] for n in s.inputs} for s in sdefs]
        if owned is None or it < iters - 1:
            views = [brick_apply(s, i, adj, params)
                     for s, i in zip(sdefs, ins)]
            continue
        outs = [brick_apply(s, i, adj, params, rows=owned)
                for s, i in zip(sdefs, ins)]
        for v, o in zip(views, outs):
            v.index_copy_(0, owned, o)
    return views
