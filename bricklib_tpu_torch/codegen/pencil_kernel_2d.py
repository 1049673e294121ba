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

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches K6
(y-streaming blocks as :meth:`Plan2D.stream` plans them) or raises.  K6 takes linear stencils: the host folds each output into a tap
table ``(field, dy, dx) -> coefficient`` by running the evaluator over
linear forms.  ``lookahead`` and ``vmem_limit_bytes`` (TPU scheduling) are
accepted and change nothing.
"""

from __future__ import annotations

import math
import numbers
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..core import not_ported
from .evaluate import TorchNS, evaluate, resolve_const_from_params
from .pencil_kernel import FEATURES_ITEM, _is_f32
from .taps import as_ir

__all__ = ["K6_RADII", "K6_SMEM_BUDGET", "K6_THREADS", "Plan2D",
           "RowStreamPlan", "fold_linear_forms", "launch_2d",
           "pencil_sweep_2d", "pencil_sweep_2d_kernel",
           "pencil_sweep_2d_plain", "row_footprint", "row_smem"]

# K6's y-streaming blocks (csrc/row_stream.cuh) on the H100: threads per
# block, the shared memory one block may take (227 KB), rows a thread
# computes at once (R6_UR), the widest x tile the planner tries
K6_THREADS = 256
K6_SMEM_BUDGET = 232448
K6_ROWS = 8
K6_RADII = (1, 2, 4, 8)     # y radii K6 is compiled for
MAX_TILE_X = 1024
GENERIC_TILE_X = 128
MAX_CHUNK = 32
# the planner's costs in SM clocks (mxu_kernel's model): thread
# instructions issue at 128 a clock with 16 warps or more resident (fewer
# leave the schedulers idle in proportion), a level-0 float loaded costs as
# much as 2, an item 120 besides its loads, FMAs and stores; a step's
# latency (its barrier, the next group's arrival); a block's start.  Fitted
# to K6's footprints at 16384^2 on the H100 (bench/k6_regimes.py
# --footprints): the pick within 10% of the best of each sweep.
ISSUE_RATE, FULL_WARPS, LOAD_INSTR, ITEM_INSTR = 128, 16, 2, 120
STEP_CLOCKS, BLOCK_CLOCKS = 50, 1000
SM_COUNT, SM_SMEM, SM_BLOCK_RESERVE, SM_THREADS = 132, 233472, 1024, 2048
PLANE_SPAN = 1 << 20
# registers a thread holds (ptxas: the box's compiled body 122, the generic
# bodies 79 to 116), which bound the blocks an SM holds
REGS_LAYOUT, REGS_GENERIC = 128, 112
# the folded form K6 compiles in (LayoutBox9 in csrc/row_stream.cuh): the
# 9-point box's groups, one field, dx in first-use order, three non-zero dy
# coefficients each
ROW_LAYOUT_BOX9 = {"fields": 1, "rad": 1, "dx": (0, 1, -1)}
# row widths (x tile and margins) the box's body is compiled for
ROW_WIDTHS = (128, 256, 512)
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

    def layout(self) -> bool:
        """The folded groups equal the ones K6 compiles in
        (:data:`ROW_LAYOUT_BOX9`), every coefficient non-zero: the entry
        point then runs that body at x tiles whose rows are
        :data:`ROW_WIDTHS` floats."""
        if self.taps is None or len(self.taps) != 1:
            return False
        gbeg, gfield, gdx, coef = self.groups()
        return (len(self.fields) == ROW_LAYOUT_BOX9["fields"]
                and self.rad() == ROW_LAYOUT_BOX9["rad"]
                and tuple(gdx.tolist()) == ROW_LAYOUT_BOX9["dx"]
                and not gfield.any() and bool(np.all(coef != 0)))

    def stream(self) -> "RowStreamPlan":
        """Kernel K6's launch: the block footprint (brick rows per chunk,
        x tile, lookahead) of least estimated cost over :data:`SM_COUNT`
        SMs whose shared memory fits :data:`K6_SMEM_BUDGET`."""
        gbeg, _gf, _gdx, coef = self.groups()
        nnz = int(np.count_nonzero(coef))
        return _row_stream_plan(self.bdims, self.y_range, self.fuse,
                                self.lo, self.hi, len(self.fields),
                                len(self.taps), int(gbeg[-1]), nnz,
                                self.rad(), self.layout())

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

    def loads(self, sp: "RowStreamPlan | None" = None) -> dict:
        """Per output element at ``sp``'s footprint (the planner's by
        default): ``level0``, the level-0 floats a block loads (its
        groups' rows over ``tx + 2h`` columns, every field); ``levels``,
        the level evaluations it computes (levels 1 to F-1 over the
        groups' rows and all columns in warps of 32, level F over its
        groups' rows and the output columns); ``shared``, the shared loads
        of one evaluation (each group's column of 8 + 2 rad rows for 8
        rows)."""
        sp = self.stream() if sp is None else sp
        BY, X = self.bdims
        F, ry = self.fuse, self.lo[0] + self.hi[0]
        rw = sp.tx + 2 * sp.h
        nout = (self.y_range[1] - self.y_range[0]) * BY * X
        level0 = levels = 0
        for (r0, r1), _x in sp.blocks():
            L = (r1 - r0) * BY
            ng = [-(-(L + (F - lv) * ry) // sp.g) for lv in range(F + 1)]
            level0 += len(self.fields) * ng[0] * sp.g * rw
            levels += sum(ng[lv] * sp.g * 32 * -(-rw // 32)
                          for lv in range(1, F))
            levels += ng[F] * sp.g * 32 * -(-sp.tx // 32)
        gbeg, _gf, _gdx, _c = self.groups()
        ngroups = int(gbeg[-1]) / len(self.taps)
        return {"level0": level0 / nout, "levels": levels / nout,
                "shared": (K6_ROWS + 2 * self.rad()) * ngroups / K6_ROWS}

    def flops_per_output(self) -> int:
        """f32 operations per output element per level of a linear
        stencil: one multiply and one add per folded tap."""
        return 2 * sum(len(t) for t in self.taps) // len(self.taps)


@dataclass(frozen=True)
class RowStreamPlan:
    """K6's launch as :meth:`Plan2D.stream` plans it: the output brick
    rows stream in chunks of ``ych`` rows, ``tx`` columns per block, in
    groups of ``g`` rows; level 0 is loaded with an x margin of ``h``
    columns per side in pieces of ``pw`` floats, ``d`` groups ahead.
    The last x tile may end past X (its columns there are not stored).
    ``smem_bytes`` is the launch's dynamic shared memory."""

    y_range: tuple
    bdims: tuple
    ych: int
    tx: int
    h: int
    pw: int
    d: int
    g: int
    smem_bytes: int

    @property
    def nchunk(self) -> int:
        Y0, Y1 = self.y_range
        return -(-(Y1 - Y0) // self.ych)

    @property
    def nxt(self) -> int:
        return -(-self.bdims[1] // self.tx)

    @property
    def nstream(self) -> int:
        return self.nchunk * self.nxt

    def blocks(self) -> list:
        """Every block of the launch in grid order, decoded as the kernel
        decodes it: ``((r0, r1), (x0, x1))`` in brick rows and columns
        (the last x tile cut at X)."""
        Y0, Y1 = self.y_range
        X = self.bdims[1]
        out = []
        for b in range(self.nstream):
            xt, ch = b % self.nxt, b // self.nxt
            r0 = Y0 + ch * self.ych
            out.append(((r0, min(r0 + self.ych, Y1)),
                        (xt * self.tx, min((xt + 1) * self.tx, X))))
        return out


def row_groups(lo, hi) -> int:
    """Rows per group: a multiple of :data:`K6_ROWS` no smaller than the
    y reach (a group's reads reach that far into the next)."""
    ry = lo[0] + hi[0]
    return K6_ROWS * max(1, -(-ry // K6_ROWS))


def row_smem(bdims, fuse: int, lo, hi, nf: int, ych: int, tx: int, h: int,
             d: int, rad: int, g: int | None = None) -> int:
    """Dynamic shared memory of one K6 block, laid out as
    ``row_stream.cuh`` lays it out: per input field a level-0 ring of
    ``d + 2`` groups, per intermediate level a ring of 3, every ring
    ``3 rad`` rows more (padding before, the run past its last slot after)
    of ``tx + 2h`` floats and ``h + 32`` floats before and after, the count
    rounded up to even; then the brick table (the brick rows level 0
    touches, 64-bit offsets) and two buffers of a group's output row
    offsets.  ``g``: rows per group (:func:`row_groups` by default)."""
    BY, _X = bdims
    g = row_groups(lo, hi) if g is None else g
    ry = lo[0] + hi[0]
    rw, pad = tx + 2 * h, h + 32

    def ring(slots):
        return (3 * rad + slots * g) * rw + 2 * pad

    n = (nf * ring(d + 2) + (fuse - 1) * ring(3) + 1) & ~1
    nbricks = (ych * BY + fuse * ry + g - 1) // BY + 2
    return 4 * n + 8 * nbricks + 16 * g


@lru_cache(maxsize=256)
def _row_stream_plan(bdims, y_range, fuse: int, lo, hi, nf: int, nout: int,
                     ngroups: int, nnz: int, rad: int, layout: bool = False,
                     budget: int = K6_SMEM_BUDGET) -> RowStreamPlan:
    BY, X = bdims
    Y0, Y1 = y_range
    nrows, F = Y1 - Y0, fuse
    ry = lo[0] + hi[0]
    pw = 4 if X % 4 == 0 else 1
    h = -(-F * max(lo[1], hi[1]) // pw) * pw
    # chunks of at most MAX_CHUNK brick rows (longer ones were no faster
    # in any regime, and slower on the wave system)
    chunks = sorted(c for c in {-(-nrows // n) for n in range(1, nrows + 1)}
                    if c <= MAX_CHUNK
                    and (c + 2) * BY + F * ry + 16 * K6_ROWS < PLANE_SPAN)
    # thread instructions of one item (8 rows of a column): per group its
    # column's loads, the non-zero coefficients' FMAs over 8 rows, the
    # stores, and some fixed work
    per_item = ((K6_ROWS + 2 * rad) * ngroups + K6_ROWS * nnz
                + K6_ROWS * nout + ITEM_INSTR)
    # a load's address: an instruction of its own outside the box's compiled
    # body
    addr = (K6_ROWS + 2 * rad) * ngroups
    nwarp = K6_THREADS // 32
    best = None
    # one group ahead, groups of 8 rows under the box's compiled body and
    # of 16 under the generic one: the best of K6's footprints at 16384^2
    # on the H100 in every regime (bench/k6_regimes.py --footprints)
    for g in (row_groups(lo, hi) * (1 if layout else 2),):
        # x tiles that divide X, and those whose rows are whole warps of
        # 32 columns (tx + 2h a multiple of 32; the last tile cut at X)
        # (the generic body's tiles at most GENERIC_TILE_X: its wider ones
        # were slower on the wave system)
        top = min(X, MAX_TILE_X if layout else GENERIC_TILE_X)
        txs = {t for t in range(pw, top + 1, pw) if X % t == 0}
        txs |= {t for t in range(64 - 2 * h, top + 1, 32)
                if t > 0 and t % pw == 0}
        for tx in sorted(txs):
            rw = tx + 2 * h
            # the box's compiled body (at its row widths) takes two
            # 32-column chunks an item
            nc = 2 if layout and rw in ROW_WIDTHS else 1
            cmid, cout = -(-rw // (32 * nc)), -(-tx // (32 * nc))
            for ych in chunks:
                L = ych * BY
                ngr = [-(-(L + (F - lv) * ry) // g) for lv in range(F + 1)]
                lags = [0] + [1 if lv == 1 else 2 * lv - 1
                              for lv in range(1, F + 1)]
                nsteps = ngr[F] + lags[F]
                # per step the items of its active levels, in whole rounds
                # of the block's warps
                rounds = 0
                for st in range(nsteps):
                    items = sum(g // K6_ROWS * (cmid if lv < F else cout)
                                for lv in range(1, F + 1)
                                if 0 <= st - lags[lv] < ngr[lv])
                    rounds += -(-items // nwarp)
                item = nc * per_item + (0 if nc == 2 else addr)
                work = (rounds * nwarp * 32 * item
                        + LOAD_INSTR * nf * ngr[0] * g * rw)
                nblocks = -(-nrows // ych) * -(-X // tx)
                for d in (1,):
                    smem = row_smem(bdims, F, lo, hi, nf, ych, tx, h, d,
                                    rad, g)
                    if smem > budget:
                        continue
                    bps = min(SM_SMEM // (smem + SM_BLOCK_RESERVE),
                              SM_THREADS // K6_THREADS,
                              65536 // (K6_THREADS * (
                                  REGS_LAYOUT if nc == 2
                                  else REGS_GENERIC)))
                    per_sm = -(-nblocks // SM_COUNT)
                    rate = ISSUE_RATE * min(1.0, min(bps, per_sm) * nwarp
                                            / FULL_WARPS)
                    # a launch that leaves block slots of the card empty
                    # comes last
                    cost = (nblocks < SM_COUNT * bps,
                            per_sm * work / rate
                            + -(-per_sm // bps) * (nsteps * STEP_CLOCKS
                                                   + BLOCK_CLOCKS),
                            -d, tx, ych, g)
                    if best is None or cost < best[0]:
                        best = (cost, (ych, tx, d, g, smem))
    if best is None:
        raise ValueError(f"no K6 y-streaming block of bricks {bdims} fits "
                         f"{budget} bytes of shared memory at fuse={F}")
    ych, tx, d, g, smem = best[1]
    return RowStreamPlan(y_range, bdims, ych, tx, h, pw, d, g, smem)


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
    """Launch kernel K6 on CUDA tensors, as :meth:`Plan2D.stream` plans
    it; returns one fresh storage per output whose unwritten bricks are
    undefined."""
    outs = launch_2d(views, table, plan, None)
    pencil_sweep_2d_kernel.launches += 1
    return outs


def row_footprint(plan: Plan2D, ych: int, tx: int, d: int,
                  g: int | None = None) -> RowStreamPlan:
    """The launch of ``plan`` at another footprint (chunk, x tile,
    lookahead, rows per group: the planner's by default), its shared
    memory counted from that footprint."""
    sp = plan.stream()
    g = sp.g if g is None else g
    return RowStreamPlan(sp.y_range, sp.bdims, ych, tx, sp.h, sp.pw, d, g,
                         row_smem(plan.bdims, plan.fuse, plan.lo, plan.hi,
                                  len(plan.fields), ych, tx, sp.h, d,
                                  plan.rad(), g))


def launch_2d(views: Sequence[torch.Tensor], table: torch.Tensor,
              plan: Plan2D, sp: RowStreamPlan | None) -> list[torch.Tensor]:
    """K6 at ``sp``'s footprint (``None``: the planner's)."""
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
    rad = plan.rad()
    sp = (plan.stream() if sp is None
          else row_footprint(plan, sp.ych, sp.tx, sp.d, sp.g))
    if sp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K6 takes at most 2^31 - 1 blocks")
    Y0, Y1 = plan.y_range
    gbeg, gfield, gdx, coef = plan.groups()
    outs = [torch.empty_like(views[0]) for _ in plan.taps]
    ins = np.asarray([v.data_ptr() for v in views], np.int64)
    optr = np.asarray([o.data_ptr() for o in outs], np.int64)
    (ylo, xlo), (yhi, xhi) = plan.lo, plan.hi
    # 16-byte pieces need 16-byte aligned storage (a view may start anywhere)
    pw = sp.pw if all(v.data_ptr() % 16 == 0 for v in views) else 1
    err = _build.library().bt_pencil_sweep_2d(
        ins.ctypes.data, optr.ctypes.data, table.data_ptr(), len(views),
        len(outs), GY, BY, X, Y0, Y1, plan.fuse, ylo, yhi, xlo, xhi,
        sp.ych, sp.tx, sp.h, pw, sp.d, sp.g, rad, len(gfield),
        gbeg.ctypes.data, gfield.ctypes.data, gdx.ctypes.data,
        coef.ctypes.data, sp.smem_bytes, K6_THREADS,
        _build.stream_handle(dev))
    _build.check(err, "pencil_sweep_2d")
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
    args = trace.sweep_args("K6", F, (plan.y_range,))

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
        with trace.span(trace.SWEEP, args):
            outs = run(views, tables[dev], plan)
        return tuple(outs) if NO > 1 else outs[0]

    fn.plan = plan
    fn.fuse = F
    if NF > 1:
        fn.fields = tuple(fieldnames)
    return fn
