"""The 2-D whole-row sweep on PyTorch (port of
``bricklib_tpu/codegen/pencil_kernel_2d.py``).

:func:`pencil_sweep_2d` has the meaning of the reference's
``pallas_pencil_sweep_2d``: storage ``[nbricks, BY, X]`` holds bricks of
BY whole domain rows, read through a 1-D row table ``ids[GY]``; output
brick row ``r`` in ``y_range`` is computed from the slab of bricks
``ids[clip(r-1)]``, ``ids[r]``, ``ids[clip(r+1)]``.  The semantics, which
:func:`pencil_sweep_2d_plain` spells out and kernel K6
(``csrc/pencil_sweep_2d.cu``) reproduces:

- level 0 at row ``yy`` is row ``yy % BY`` of brick
  ``ids[clip(yy // BY)]``: rows beyond the table clamp to the edge brick,
  whole bricks at a time; x is periodic modulo the whole width X;
- ``fuse`` = F computes the in-window trapezoid: level l (1..F) has
  ``BY + (F-l)(lo+hi)`` rows, computed from level l-1 with no clamp in
  between; level F goes to brick ``ids[r]`` of each output, and every
  other brick of an output is undefined, as on the TPU;
- F > 1 only for single-input single-output stencils with ``F * lo <= BY``
  and ``F * hi <= BY``; multi-input stencils and systems run at F = 1,
  take their inputs in ``fn.fields`` order and return one view per output.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches K6 or
raises.  K6 takes linear stencils: the host folds each output into a tap
table ``(field, dy, dx) -> coefficient`` by running the evaluator over
linear forms.  ``lookahead`` and ``vmem_limit_bytes`` (TPU scheduling) are
accepted and change nothing.
"""

from __future__ import annotations

import math
import numbers
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .evaluate import TorchNS, evaluate, resolve_const_from_params
from .pencil_kernel import FEATURES_ITEM, _is_f32
from .taps import as_ir

__all__ = ["K6_RADII", "K6_SMEM_BUDGET", "K6_THREADS", "Plan2D",
           "fold_linear_forms", "pencil_sweep_2d", "pencil_sweep_2d_kernel",
           "pencil_sweep_2d_plain"]

K6_THREADS = 256
# shared memory per block: 113 KiB lets two blocks share one SM
K6_SMEM_BUDGET = 113 * 1024
K6_ROWS = 8                 # output rows per thread strip (K6_R in the .cu)
K6_RADII = (1, 2, 4, 8)     # y radii K6 is compiled for
MAX_TILE_X = 128
K6_MAX_FIELDS = 8
K6_MAX_OUT = 8
K6_MAX_GROUPS = 64
K6_MAX_COEF = 512


class _Nonlinear(Exception):
    """The stencil is not a linear form of its taps."""


class _Linear:
    """A linear form of tap reads: ``{(field, dy, dx): coefficient}``.
    Only sums, differences, negation and products or quotients by a number
    are linear; anything else raises :class:`_Nonlinear`."""

    def __init__(self, terms):
        self.terms = terms

    def _merge(self, other, sign):
        if not isinstance(other, _Linear):
            raise _Nonlinear("a constant term")
        out = dict(self.terms)
        for k, c in other.terms.items():
            out[k] = out.get(k, 0.0) + sign * c
        return _Linear(out)

    def _scale(self, c):
        if not isinstance(c, numbers.Real):
            raise _Nonlinear("a product of taps")
        return _Linear({k: v * float(c) for k, v in self.terms.items()})

    def __add__(self, other):
        return self._merge(other, 1.0)

    __radd__ = __add__

    def __sub__(self, other):
        return self._merge(other, -1.0)

    def __rsub__(self, other):
        return (-self)._merge(other, 1.0)

    def __neg__(self):
        return self._scale(-1.0)

    def __pos__(self):
        return self

    def __mul__(self, c):
        return self._scale(c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        if not isinstance(c, numbers.Real):
            raise _Nonlinear("a quotient by a tap")
        return self._scale(1.0 / float(c))

    def __rtruediv__(self, c):
        raise _Nonlinear("a quotient by a tap")

    def __mod__(self, c):
        raise _Nonlinear("a modulo")

    __rmod__ = __mod__


class _LinearNS:
    """The evaluator's array namespace over linear forms: functions of
    numbers stay numbers; functions of taps are nonlinear."""

    def __getattr__(self, name):
        scalar = {"maximum": max, "minimum": min, "abs": abs,
                  "sqrt": math.sqrt, "exp": math.exp, "log": math.log}

        def fn(*args):
            if name not in scalar or any(isinstance(a, _Linear)
                                         for a in args):
                raise _Nonlinear(name)
            return scalar[name](*args)

        return fn


def fold_linear_forms(ir, fields: Sequence[str], params: dict):
    """A stencil of any rank as ``((field index, *offsets), coefficient)``
    pairs in first-seen order, offsets in numpy axis order (2-D: ``(f, dy,
    dx)``, 3-D: ``(f, dk, dj, di)``), coefficients of one tap summed; None
    when the stencil is not linear in its taps."""
    uidx = {n: f for f, n in enumerate(fields)}
    nd = ir.dims

    def read_tap(name, offs):
        return _Linear({(uidx[name],) + tuple(
            int(offs[nd - 1 - a]) for a in range(nd)): 1.0})

    try:
        form = evaluate(ir.sdef.rhs, read_tap,
                        resolve_const_from_params(params), _LinearNS())
    except (_Nonlinear, TypeError):
        return None
    if not isinstance(form, _Linear):
        return None
    return tuple((k, float(c)) for k, c in form.terms.items())


@dataclass(frozen=True)
class Plan2D:
    """Everything static about one 2-D sweep: brick shape ``(BY, X)``, the
    row table, the output brick rows ``y_range``, fused levels, the radius
    per side in numpy order ``(y, x)`` (the largest over a system), the
    outputs' IRs, the input fields in ``fn.fields`` order, the params and,
    for a linear stencil, each output's folded taps (None otherwise)."""

    bdims: tuple
    table: np.ndarray
    y_range: tuple
    fuse: int
    lo: tuple
    hi: tuple
    irs: tuple
    fields: tuple
    params: dict
    taps: tuple | None

    def written_bricks(self) -> np.ndarray:
        """Storage ids this sweep writes in each output (sorted, unique)."""
        return np.unique(self.table[self.y_range[0]:self.y_range[1]])

    def rad(self) -> int:
        """The y radius K6 is compiled for that covers this stencil."""
        need = max(self.lo[0], self.hi[0])
        for r in K6_RADII:
            if r >= need:
                return r
        raise ValueError(f"kernel K6 takes a y radius of at most "
                         f"{K6_RADII[-1]}, got {need}")

    def tile(self) -> tuple[int, int]:
        """(x columns per block, shared-memory bytes) for kernel K6: the
        widest power-of-two tile dividing X, at most :data:`MAX_TILE_X`,
        whose level buffers and row offsets fit :data:`K6_SMEM_BUDGET`."""
        BY, X = self.bdims
        F, rad = self.fuse, self.rad()
        ry = self.lo[0] + self.hi[0]
        rx = self.lo[1] + self.hi[1]
        h0, h1 = BY + F * ry, BY + (F - 1) * ry
        nb0 = 1 if F > 1 else len(self.fields)
        tx = MAX_TILE_X
        while tx >= 1:
            if X % tx == 0:
                s0 = (h0 + 2 * rad + K6_ROWS) * (tx + F * rx)
                s1 = ((h1 + 2 * rad + K6_ROWS) * (tx + (F - 1) * rx)
                      if F > 1 else 0)
                nbytes = 4 * ((nb0 * s0 + s1 + 1) & ~1) + 8 * h0
                if nbytes <= K6_SMEM_BUDGET:
                    return tx, nbytes
            tx //= 2
        raise ValueError(f"no x tile of X={X} fits {K6_SMEM_BUDGET} bytes "
                         f"of shared memory at fuse={F}")

    def groups(self):
        """K6's tap groups: per output, one group per distinct (field, dx)
        with a coefficient per dy in ``[-rad, rad]``.  Returns (group
        bounds per output, fields, dx, coefficients) as numpy arrays."""
        rad = self.rad()
        gbeg, gfield, gdx, coef = [0], [], [], []
        for taps in self.taps:
            index: dict = {}
            for (f, dy, dx), c in taps:
                if (f, dx) not in index:
                    index[(f, dx)] = len(gfield)
                    gfield.append(f)
                    gdx.append(dx)
                    coef.append([0.0] * (2 * rad + 1))
                coef[index[(f, dx)]][dy + rad] += c
            gbeg.append(len(gfield))
        if len(gfield) > K6_MAX_GROUPS or \
                len(gfield) * (2 * rad + 1) > K6_MAX_COEF:
            raise ValueError(f"kernel K6 takes at most {K6_MAX_GROUPS} "
                             f"(field, dx) groups and {K6_MAX_COEF} "
                             "coefficients")
        return (np.asarray(gbeg, np.int32), np.asarray(gfield, np.int32),
                np.asarray(gdx, np.int32),
                np.asarray(coef, np.float32).reshape(-1))

    def flops_per_output(self) -> int:
        """f32 operations per output element per level of a linear
        stencil: one multiply and one add per folded tap."""
        return 2 * sum(len(t) for t in self.taps) // len(self.taps)


def pencil_sweep_2d_plain(views: Sequence[torch.Tensor], table: torch.Tensor,
                          plan: Plan2D) -> list[torch.Tensor]:
    """The plain PyTorch version of kernel K6, on any device: each output
    brick row's slab as a dense ``[rows, BY + F(lo+hi), X]`` tensor, the
    levels computed with ``torch.roll`` in x; returns one fresh storage per
    output whose unwritten bricks are undefined."""
    BY, X = plan.bdims
    F = plan.fuse
    (ylo, _xlo), (yhi, _xhi) = plan.lo, plan.hi
    Y0, Y1 = plan.y_range
    GY = plan.table.shape[0]
    dev = views[0].device
    ids = table.long()
    yy = (torch.arange(Y0, Y1, device=dev)[:, None] * BY - F * ylo
          + torch.arange(BY + F * (ylo + yhi), device=dev)[None, :])
    yb = torch.div(yy, BY, rounding_mode="floor")
    rows = ids[yb.clamp(0, GY - 1)]
    slabs = [v[rows, yy - yb * BY] for v in views]
    resolve = resolve_const_from_params(plan.params)

    def level(srcs, k, ho):
        def tap(f, dy, dx):
            v = srcs[f][:, ylo + dy:ylo + dy + ho]
            return torch.roll(v, -dx, dims=2) if dx else v

        if plan.taps is not None:
            acc = None
            for (f, dy, dx), c in plan.taps[k]:
                t = c * tap(f, dy, dx)
                acc = t if acc is None else acc + t
            return acc
        uidx = {n: f for f, n in enumerate(plan.fields)}
        out = evaluate(plan.irs[k].sdef.rhs,
                       lambda name, offs: tap(uidx[name], int(offs[1]),
                                              int(offs[0])),
                       resolve, TorchNS)
        return out.to(views[0].dtype)

    if F == 1:
        finals = [level(slabs, k, BY) for k in range(len(plan.irs))]
    else:
        slab = slabs[0]
        for lv in range(1, F + 1):
            slab = level([slab], 0, BY + (F - lv) * (ylo + yhi))
        finals = [slab]
    wids = ids[Y0:Y1]
    outs = []
    for vals in finals:
        out = torch.empty_like(views[0])
        out[wids] = vals
        outs.append(out)
    return outs


def pencil_sweep_2d_kernel(views: Sequence[torch.Tensor],
                           table: torch.Tensor,
                           plan: Plan2D) -> list[torch.Tensor]:
    """Launch kernel K6 on CUDA tensors; returns one fresh storage per
    output whose unwritten bricks are undefined."""
    dev = views[0].device
    if dev.type != "cuda" or table.device != dev or any(
            v.device != dev for v in views):
        raise ValueError("kernel K6 takes storage and table on one CUDA "
                         f"device, got {[str(v.device) for v in views]} and "
                         f"{table.device}")
    if plan.taps is None:
        raise not_ported("a nonlinear 2-D stencil on a CUDA tensor",
                         FEATURES_ITEM)
    BY, X = plan.bdims
    GY = plan.table.shape[0]
    shape = tuple(views[0].shape)
    for v in views:
        if (v.dtype != torch.float32 or v.dim() != 3
                or tuple(v.shape) != shape or tuple(v.shape[1:]) != (BY, X)
                or not v.is_contiguous()):
            raise ValueError(f"storage must be contiguous float32 [nb, {BY}, "
                             f"{X}], got {v.dtype} {tuple(v.shape)}")
    if (table.dtype != torch.int32 or tuple(table.shape) != (GY,)
            or not table.is_contiguous()):
        raise ValueError(f"table must be contiguous int32 [{GY}]")
    if len(views) > K6_MAX_FIELDS or len(plan.taps) > K6_MAX_OUT:
        raise ValueError(f"kernel K6 takes at most {K6_MAX_FIELDS} inputs "
                         f"and {K6_MAX_OUT} outputs")
    Y0, Y1 = plan.y_range
    if Y1 - Y0 > 65535:
        raise ValueError("kernel K6 takes at most 65535 brick rows")
    rad = plan.rad()
    tx, smem = plan.tile()
    gbeg, gfield, gdx, coef = plan.groups()
    outs = [torch.empty_like(views[0]) for _ in plan.taps]
    ins = np.asarray([v.data_ptr() for v in views], np.int64)
    optr = np.asarray([o.data_ptr() for o in outs], np.int64)
    (ylo, xlo), (yhi, xhi) = plan.lo, plan.hi
    err = _build.library().bt_pencil_sweep_2d(
        ins.ctypes.data, optr.ctypes.data, table.data_ptr(), len(views),
        len(outs), GY, BY, X, Y0, Y1, plan.fuse, ylo, yhi, xlo, xhi, tx,
        rad, len(gfield), gbeg.ctypes.data, gfield.ctypes.data,
        gdx.ctypes.data, coef.ctypes.data, smem, K6_THREADS,
        _build.stream_handle(dev))
    _build.check(err, "pencil_sweep_2d")
    pencil_sweep_2d_kernel.launches += 1
    return outs


pencil_sweep_2d_kernel.launches = 0


def pencil_sweep_2d(stencil, grid: np.ndarray,
                    bdims: Sequence[int],
                    nbricks: int,
                    params: dict | None = None,
                    y_range: tuple[int, int] | None = None,
                    dtype=torch.float32,
                    interpret: bool | None = None,
                    lookahead: int = 2,
                    fuse: int = 1,
                    vmem_limit_bytes: int = 110 * 2 ** 20):
    """Build ``fn(*views) -> view(s)`` over ``[nbricks, BY, X]`` storage
    for a 2-D stencil or stencil system.  ``grid`` is the 1-D brick-row
    table (shape ``(GY,)`` or ``(GY, 1)``); ``bdims = (BY, X)`` with X the
    whole domain width (x-periodic).

    Arguments and errors follow ``pallas_pencil_sweep_2d``
    (``bricklib_tpu/codegen/pencil_kernel_2d.py:42``), but for its
    hardware-only rule (``X % 128``, ``BY % 8``), which is the TPU's tile
    shape.  Storage types other than float32 raise ``NotImplementedError``;
    a nonlinear stencil runs on CPU tensors only."""
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    irs = [as_ir(s) for s in sdefs]
    NO = len(irs)
    params = dict(params or {})
    if any(r.dims != 2 for r in irs):
        raise NotImplementedError("pallas_pencil_sweep_2d is 2-D")
    fieldnames: list = []
    for r_ in irs:
        for n in r_.sdef.inputs:
            if n not in fieldnames:
                fieldnames.append(n)
    NF = len(fieldnames)
    if NF == 0:
        raise ValueError("stencil reads no input grid")
    BY, X = (int(b) for b in bdims)
    los, his = zip(*(r_.radius() for r_ in irs))
    lo = np.max(np.asarray(los), axis=0)
    hi = np.max(np.asarray(his), axis=0)
    lo0, hi0 = int(lo[0]), int(hi[0])
    if lo0 > BY or hi0 > BY:
        raise ValueError("y radius exceeds brick depth")
    if lo[1] >= X or hi[1] >= X:
        raise ValueError("x radius exceeds domain width")
    grid = np.asarray(grid)
    if grid.ndim == 2:
        if grid.shape[1] != 1:
            raise ValueError("2-D pencil table is one brick per y row")
        grid = grid[:, 0]
    GY = grid.shape[0]
    if y_range is None:
        y_range = (1, GY - 1)
    Y0, Y1 = (int(y) for y in y_range)
    if not (0 <= Y0 < Y1 <= GY):
        raise ValueError("y_range outside table")
    if not _is_f32(dtype):
        raise not_ported("storage types other than float32",
                         FEATURES_ITEM)
    F = int(fuse)
    if F < 1:
        raise ValueError("fuse must be >= 1")
    if F > 1 and (NF != 1 or NO != 1):
        raise ValueError("fuse > 1 is single-input single-output")
    if F * lo0 > BY or F * hi0 > BY:
        raise ValueError(f"fuse {F} x y-radius ({lo0}, {hi0}) exceeds "
                         f"brick depth {BY}")
    folded = [fold_linear_forms(r_, fieldnames, params) for r_ in irs]
    plan = Plan2D(
        bdims=(BY, X), table=np.ascontiguousarray(grid, np.int32),
        y_range=(Y0, Y1), fuse=F, lo=(lo0, int(lo[1])),
        hi=(hi0, int(hi[1])), irs=tuple(irs), fields=tuple(fieldnames),
        params=params,
        taps=None if any(t is None for t in folded) else tuple(folded))
    t = plan.table
    if t.size and (int(t.min()) < 0 or int(t.max()) >= int(nbricks)):
        raise ValueError(f"table ids span [{int(t.min())}, {int(t.max())}], "
                         f"outside {int(nbricks)} bricks")
    shape = (int(nbricks), BY, X)
    tables: dict = {}

    def fn(*views):
        if len(views) != NF:
            raise TypeError(f"fn takes {NF} view(s) in fn.fields "
                            f"order, got {len(views)}")
        for v in views:
            if tuple(v.shape) != shape:
                raise ValueError(f"storage shape {tuple(v.shape)} is not "
                                 f"{shape}")
        dev = views[0].device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
        run = (pencil_sweep_2d_plain if dev.type == "cpu"
               else pencil_sweep_2d_kernel)
        outs = run(views, tables[dev], plan)
        return tuple(outs) if NO > 1 else outs[0]

    fn.plan = plan
    fn.fuse = F
    if NF > 1:
        fn.fields = tuple(fieldnames)
    return fn
