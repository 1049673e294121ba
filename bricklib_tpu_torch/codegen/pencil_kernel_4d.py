"""The fused 4-D pencil sweep on PyTorch (port of
``bricklib_tpu/codegen/pencil_kernel_4d.py``; ref: weak/main-4d.cpp:36-53).

:func:`pencil_sweep_4d` has the meaning of the reference's
``pallas_pencil_sweep_4d``: storage ``[nbricks, BW, BK, BJ, BI]`` is read
through a grid table ``T[GW, GK, GJ]`` with one pencil brick (the whole i
extent) per (w, k, j) cell; the sweep computes the bricks ``w_range`` x
``k_range`` x ``j_range`` and applies ``fuse`` = F stencil iterations per
pass over device memory.  The rules are the 3-D sweep's with w treated
like j (``codegen/pencil_kernel.py``): level 0 clamps whole bricks at the
table edge in w, k and j, including the w-halo slices of the w+-1 bricks;
intermediate levels extend (F - f) radii in w and j with no clamp; their k
rows beyond the table take the clamped row's values; i is periodic.

:func:`pencil_sweep_4d_plain` (the rank-generic plain sweep) spells these
rules out as dense tensor code, and kernel K4 (``csrc/pencil_sweep_4d.cu``;
for the 4-D star at ``fuse=2`` its register-streaming body,
``csrc/pencil_regstream_4d.cu``, where :func:`regstream_plan_4d` plans it)
reproduces them.  A CPU tensor takes the plain version; a CUDA tensor
launches K4 or raises.  The TPU scheduling arguments (``tile_j``,
``lookahead``, ``vmem_limit_bytes``, ``interpret``) are checked as the
reference checks them and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .pencil_kernel import (BLOCK_COST, FEATURES_ITEM, LOAD_COST,
                            MAX_PENCILS, PLANE_SPAN, RS_LEVEL_COST,
                            RS_STEP_COST, SM_COUNT, STEP_COST, STREAM_ROWS,
                            STREAM_SMEM_BUDGET, STREAM_THREADS, SYNC_COST,
                            SweepPlan, _is_f32, _layouts, stream_loads,
                            sweep_fn)
from .pencil_kernel import pencil_sweep_plain as pencil_sweep_4d_plain
from .taps import as_ir, params_from_reference

__all__ = ["K4_SMEM_BUDGET", "K4_THREADS", "RegStream4Plan", "Stream4Plan",
           "k4_launch", "launch_regstream_4d", "pencil_sweep_4d",
           "pencil_sweep_4d_kernel", "pencil_sweep_4d_plain",
           "regstream4_footprint", "regstream4_smem", "regstream_plan_4d",
           "stream4_smem", "stream_plan_4d"]

# K4's ring body's w-streaming blocks (csrc/pencil_stream_4d.cuh) on the
# H100: 512 threads, one block per SM (a thread may hold 128 registers),
# up to 227 KB of shared memory a block
K4_THREADS = STREAM_THREADS
K4_SMEM_BUDGET = STREAM_SMEM_BUDGET
# k brick rows per block the planner tries
MAX_KROWS = 8
# the tap layout K4 compiles in (csrc/tap_layouts.cuh, LayoutStar9)
K4_LAYOUTS = ("mpi9pt",)
# K4's register-streaming body (csrc/pencil_regstream_4d.cu[h]): the 4-D
# star's taps at the fused depths and row widths (a plane's lanes, the i
# tile and its margins) it compiles, at most this many output j rows a
# block (a plane's j rows are these and F radii a side, compiled in), the
# k rows of a group (level 1's rows at the 4-D step's shape, one brick row
# of 8 and 2F - 2 more, are two groups) and threads per block, each owning
# one (group, column) item.  Its planner takes i tiles of a warp's 32 lanes
# or a whole brick row, narrower ones only where those leave SMs idle.
# Fuse 3 and 4 stay on the ring body: at the 4-D step's shape their items
# fit the threads only in tiles of 8 to 16 lanes, where this body ran 5%
# and 54% slower than the ring body (bench/k4_regimes.py), their warps
# spanning several j rows
REGSTREAM4_FUSE = (2,)
REGSTREAM4_ROW_WIDTHS = (40,)
REGSTREAM4_ROWS_J = 8
REGSTREAM4_ROWS_K = 5
REGSTREAM4_THREADS = 768


@dataclass(frozen=True)
class Stream4Plan:
    """K4's launch as :func:`stream_plan_4d` plans it.  The output w bricks
    stream in chunks of ``wch``; a block takes ``pk`` k brick rows,
    ``pj`` pencils and ``ti`` i lanes, level 0 loaded with an i margin of
    ``h`` lanes per side in pieces of ``pw`` floats, ``d`` planes ahead.
    Bit f of ``skew`` (1 <= f < F): levels f and f+1 are skewed by a
    plane, with no barrier between them and a plane more in level f's
    ring.  ``smem_bytes`` is the launch's dynamic shared memory; ``body``
    names the kernel body that runs it."""

    body = "stream"
    ranges: tuple
    bdims: tuple
    fuse: int
    lo: tuple
    hi: tuple
    table_k: int
    batch: int
    wch: int
    pk: int
    pj: int
    ti: int
    h: int
    pw: int
    d: int
    skew: int
    smem_bytes: int

    def _groups(self, axis: int, per: int) -> int:
        R0, R1 = self.ranges[axis]
        return -(-(R1 - R0) // per)

    @property
    def nwch(self) -> int:
        return self._groups(0, self.wch)

    @property
    def nkg(self) -> int:
        return self._groups(1, self.pk)

    @property
    def njg(self) -> int:
        return self._groups(2, self.pj)

    @property
    def nit(self) -> int:
        return self.bdims[3] // self.ti

    @property
    def nstream(self) -> int:
        return self.batch * self.nwch * self.nkg * self.njg * self.nit

    def blocks(self) -> list:
        """Every block of the launch in grid order, decoded as the kernel
        decodes it: ``(batch member, (w0, w1), (k0, k1), (j0, j1), (i0,
        i1), edges)`` in bricks and i lanes; ``edges`` names the table's k
        edges ("low", "high") whose clamp the block's intermediate levels
        apply."""
        (W0, W1), (K0, K1), (J0, J1) = self.ranges
        clamps = self.fuse > 1
        out = []
        for b in range(self.nstream):
            it, b = b % self.nit, b // self.nit
            jg, b = b % self.njg, b // self.njg
            kg, b = b % self.nkg, b // self.nkg
            wc, sub = b % self.nwch, b // self.nwch
            w0, k0 = W0 + wc * self.wch, K0 + kg * self.pk
            j0 = J0 + jg * self.pj
            k1 = min(k0 + self.pk, K1)
            edges = (("low",) * (clamps and self.lo[1] > 0 and k0 == 0)
                     + ("high",) * (clamps and self.hi[1] > 0
                                    and k1 == self.table_k))
            out.append((sub, (w0, min(w0 + self.wch, W1)), (k0, k1),
                        (j0, min(j0 + self.pj, J1)),
                        (it * self.ti, (it + 1) * self.ti), edges))
        return out


def stream4_slack(bdims, fuse: int, lo, hi, pj: int, rw: int,
                  h: int) -> int:
    """Floats after the rings that a level may read past its source plane
    (``stream4_slack`` in ``pencil_stream_4d.cuh``): a tap's reach and 32
    lanes, and with bricks less than :data:`STREAM_ROWS` deep in k a
    quad's k rows beyond a block's."""
    _, BK, BJ, _ = bdims
    w0 = (pj * BJ + fuse * (lo[2] + hi[2])) * rw
    return h + 40 + max(STREAM_ROWS - BK, 0) * w0


def stream4_smem(bdims, fuse: int, lo, hi, wch: int, pk: int, pj: int,
                 ti: int, h: int, d: int, skew: int = 0) -> int:
    """Dynamic shared memory of one w-streaming block, laid out as
    ``pencil_stream_4d.cuh`` lays it out: the level-0 ring (``rw + 1 +
    d`` planes), the rings of levels 1 to F-1 (``rw + 1`` planes each, one
    more where ``skew`` has the level's bit), every plane of level f
    ``(pk * BK + (F - f) * rk) x (pj * BJ + (F - f) * rj)`` rows of ``ti +
    2h`` floats, ``h`` floats before them and :func:`stream4_slack` after,
    the count rounded up to even; then the brick table (``(wch + 2) x (pk
    + 2) x (pj + 2)`` 64-bit offsets), two ints per level-0 row and two
    buffers of ``pk * BK x pj * BJ`` 64-bit output row offsets."""
    _, BK, BJ, _ = bdims
    rw, rk, rj = (a + b for a, b in zip(lo[:3], hi[:3]))
    RW = ti + 2 * h

    def plane(f):
        return ((pk * BK + (fuse - f) * rk) * (pj * BJ + (fuse - f) * rj)
                * RW)

    n = (rw + 1 + d) * plane(0)
    n += sum((rw + 1 + (skew >> f & 1)) * plane(f) for f in range(1, fuse))
    n = (h + n + stream4_slack(bdims, fuse, lo, hi, pj, RW, h) + 1) & ~1
    rows0 = (pk * BK + fuse * rk) * (pj * BJ + fuse * rj)
    return (4 * n + 8 * (wch + 2) * (pk + 2) * (pj + 2) + 8 * rows0
            + 16 * pk * BK * pj * BJ)


@lru_cache(maxsize=256)
def _stream_plan_4d(bdims, ranges, table_k: int, fuse: int, lo, hi,
                    batch: int, ntaps: int, loads: float,
                    budget: int) -> Stream4Plan:
    BW, BK, BJ, BI = bdims
    (W0, W1), (K0, K1), (J0, J1) = ranges
    F = fuse
    nw, nk, npen = W1 - W0, K1 - K0, J1 - J0
    pw = 4 if BI % 4 == 0 else 1
    h = -(-F * max(lo[3], hi[3]) // pw) * pw
    rw, rk, rj = (a + b for a, b in zip(lo[:3], hi[:3]))
    # a chunk's planes from its first w brick stay below 2^20 (the
    # kernel's division-free ring slots; BT_PLANE_SPAN)
    chunks = sorted(c for c in {-(-nw // n) for n in range(1, nw + 1)}
                    if (c + 2) * BW + F * (rw + 1) < PLANE_SPAN)
    lookaheads = (2,) if F == 1 and ntaps < 40 else (2, 1)
    skews = [((1 << F) - 1) ^ ((1 << (F - m)) - 1) for m in range(F)]
    # shared-memory accesses per element of a level: its loads, one store,
    # a tap's address per quad
    per_elem = loads + 1 + ntaps / STREAM_ROWS

    def quads(rows: int) -> int:
        return -(-rows // STREAM_ROWS) * STREAM_ROWS

    best = None
    for ti in (t for t in range(pw, BI + 1, pw) if BI % t == 0):
        rwid = ti + 2 * h
        lanes = -(-ti // 32) * 32
        for pj in range(1, min(npen, MAX_PENCILS) + 1):
            wj = pj * BJ
            for pk in range(1, min(nk, MAX_KROWS) + 1):
                kt = pk * BK
                for wch in chunks:
                    L = wch * BW
                    # levels 1 to F-1 over whole k rows of (j rows x rwid)
                    # floats, level F over 32-lane chunks of the output
                    # lanes, in quads of k rows
                    work = (LOAD_COST * (kt + F * rk) * (wj + F * rj) * rwid
                            * (L + F * rw)
                            + (sum(quads(kt + (F - f) * rk)
                                   * (wj + (F - f) * rj) * rwid
                                   * (L + (F - f) * rw)
                                   for f in range(1, F))
                               + quads(kt) * wj * lanes * L) * per_elem)
                    nblocks = (batch * -(-nw // wch) * -(-nk // pk)
                               * -(-npen // pj) * (BI // ti))
                    # one block per SM: a wave takes one block's work, its
                    # barriers and its start
                    waves = -(-nblocks // SM_COUNT)
                    for d, skew in ((d, m) for d in lookaheads
                                    for m in skews):
                        smem = stream4_smem(bdims, F, lo, hi, wch, pk, pj,
                                            ti, h, d, skew)
                        if smem > budget:
                            continue
                        nsk = bin(skew).count("1")
                        stall = ((L + F * rw + nsk)
                                 * (STEP_COST + (F - 1 - nsk) * SYNC_COST)
                                 + BLOCK_COST)
                        cost = (waves * (work + stall), -d, -ti, pk, wch)
                        if best is None or cost < best[0]:
                            best = (cost, (wch, pk, pj, ti, d, skew, smem))
    if best is None:
        raise ValueError(f"no K4 w-streaming block of bricks {bdims} fits "
                         f"{budget} bytes of shared memory at fuse={F}")
    wch, pk, pj, ti, d, skew, smem = best[1]
    return Stream4Plan(ranges, bdims, F, lo, hi, table_k, batch, wch, pk,
                       pj, ti, h, pw, d, skew, smem)


def stream_plan_4d(plan: SweepPlan) -> Stream4Plan:
    """Kernel K4's launch (4-D, linear taps): the footprint (w chunk, k
    brick rows, pencils, i tile, lookahead, skewed levels) of least
    estimated cost, shared-memory accesses, level-0 loads and per-step
    stalls per wave of blocks over :data:`SM_COUNT` SMs, whose shared
    memory fits :data:`K4_SMEM_BUDGET`.  Raises when none fits: K4 never
    falls back."""
    return _stream_plan_4d(tuple(plan.bdims), tuple(plan.ranges),
                           plan.table.shape[1], plan.fuse, tuple(plan.lo),
                           tuple(plan.hi), plan.batch,
                           len(plan.taps.coeffs),
                           stream_loads(plan.taps.offsets, K4_LAYOUTS),
                           K4_SMEM_BUDGET)


def stream4_footprint(plan: SweepPlan, wch: int, pk: int, pj: int, ti: int,
                      d: int, skew: int) -> Stream4Plan:
    """The launch of ``plan`` at another footprint, its shared memory
    counted from that footprint; for measuring the planner's choice
    against its neighbours."""
    sp = stream_plan_4d(plan)
    return Stream4Plan(sp.ranges, sp.bdims, sp.fuse, sp.lo, sp.hi,
                       sp.table_k, sp.batch, wch, pk, pj, ti, sp.h, sp.pw,
                       d, skew,
                       stream4_smem(plan.bdims, plan.fuse, plan.lo, plan.hi,
                                    wch, pk, pj, ti, sp.h, d, skew))


@dataclass(frozen=True)
class RegStream4Plan(Stream4Plan):
    """K4's launch through its register-streaming body, as
    :func:`regstream_plan_4d` plans it: the blocks are decoded as the ring
    body's (:meth:`Stream4Plan.blocks`), with no skewed levels; level 1's
    k rows of every level plane are ``nq`` groups of
    ``REGSTREAM4_ROWS_K`` rows, each of ``REGSTREAM4_ROWS_J + 2F`` j rows
    of ``rw`` lanes (the compiled row width, ``ti + 2h`` and up)."""

    body = "regstream"
    rw: int
    nq: int

    def items(self) -> int:
        """The (group, column) items of a block: the columns level 1 needs,
        ``(pj BJ + 2F - 2) x (ti + 2F - 2)``, in each of ``nq`` groups."""
        return (self.nq * (self.pj * self.bdims[2] + 2 * self.fuse - 2)
                * (self.ti + 2 * self.fuse - 2))


def regstream4_smem(bdims, fuse: int, wch: int, pk: int, pj: int, rw: int,
                    nq: int, d: int) -> int:
    """Dynamic shared memory of one register-streaming K4 block, laid out
    as ``pencil_regstream_4d.cuh`` lays it out: ``d + 3`` level-0 planes
    and two of each of levels 1 to F-1, every plane a leading k row of
    ``ws = (8 + 2F) rw`` floats and a pad, ``nq`` groups of ``ur =
    REGSTREAM4_ROWS_K`` k rows and a pad (``ur ws + pad`` is ``ws``
    modulo 32) and a trailing k row, the count rounded up to even; then the
    brick table (``(wch + 2) x (pk + 2) x (pj + 2)`` 64-bit offsets), three
    ints per level-0 row rounded up to even, and two buffers of ``pk BK x
    pj BJ`` 64-bit output row addresses."""
    _, BK, BJ, _ = bdims
    ws = (REGSTREAM4_ROWS_J + 2 * fuse) * rw
    ur = REGSTREAM4_ROWS_K
    pad = (32 - (ur - 1) * ws % 32) % 32
    planes = d + 3 + 2 * (fuse - 1)
    n = (planes * (ws + pad + nq * (ur * ws + pad) + ws) + 1) & ~1
    rows0 = (pk * BK + 2 * fuse) * (pj * BJ + 2 * fuse)
    return (4 * n + 8 * (wch + 2) * (pk + 2) * (pj + 2)
            + 4 * ((3 * rows0 + 1) & ~1) + 16 * pk * BK * pj * BJ)


@lru_cache(maxsize=256)
def _regstream_plan_4d(bdims, ranges, table_k: int, fuse: int, batch: int,
                       budget: int) -> RegStream4Plan | None:
    BW, BK, BJ, BI = bdims
    (W0, W1), (K0, K1), (J0, J1) = ranges
    F = fuse
    if F not in REGSTREAM4_FUSE or F > min(BW, BK, BJ):
        return None
    nw, nk, npen = W1 - W0, K1 - K0, J1 - J0
    pw = 4 if BI % 4 == 0 else 1
    h = -(-F // pw) * pw
    chunks = sorted(c for c in {-(-nw // n) for n in range(1, nw + 1)}
                    if (c + 2) * BW + 3 * F < PLANE_SPAN)

    def search(tiles):
        """The least estimated cost and footprint over the i tiles
        ``tiles`` (None where none fits), and its blocks."""
        best = None
        for ti in tiles:
            rw = min((w for w in REGSTREAM4_ROW_WIDTHS if w >= ti + 2 * h),
                     default=None)
            if rw is None:
                continue
            for pj in range(1, min(npen, MAX_PENCILS) + 1):
                wj = pj * BJ
                if wj > REGSTREAM4_ROWS_J:
                    break
                for pk in range(1, min(nk, MAX_KROWS) + 1):
                    nq = -(-(pk * BK + 2 * F - 2) // REGSTREAM4_ROWS_K)
                    # level f computes nq groups of its (wj + 2(F-f)) x
                    # (ti + 2(F-f)) columns
                    cols = [nq * (wj + 2 * (F - f)) * (ti + 2 * (F - f))
                            for f in range(1, F + 1)]
                    if cols[0] > REGSTREAM4_THREADS:
                        continue
                    # an SM's step: one block an SM (its shared memory)
                    step = RS_STEP_COST + F * RS_LEVEL_COST + sum(cols)
                    for wch in chunks:
                        nblocks = (batch * -(-nw // wch) * -(-nk // pk)
                                   * -(-npen // pj) * (BI // ti))
                        waves = -(-nblocks // SM_COUNT)
                        for d in (3, 2, 1):
                            if regstream4_smem(bdims, F, wch, pk, pj, rw,
                                               nq, d) > budget:
                                continue
                            cost = (waves * (wch * BW + 2 * F) * step, -d,
                                    -ti, pk, wch)
                            if best is None or cost < best[0]:
                                best = (cost, (wch, pk, pj, ti, rw, d),
                                        nblocks)
        return best

    # i tiles of a warp's 32 lanes or the whole brick row; narrower ones
    # only where those leave SMs without a block
    tiles = [t for t in range(pw, BI + 1, pw) if BI % t == 0]
    best = search([t for t in tiles if t >= min(32, BI)])
    if best is not None and best[2] < SM_COUNT:
        best = min(best, search([t for t in tiles if t < min(32, BI)])
                   or best)
    if best is None:
        return None
    return _reg4_plan(bdims, ranges, table_k, F, batch, *best[1])


def _reg4_plan(bdims, ranges, table_k: int, fuse: int, batch: int,
               wch: int, pk: int, pj: int, ti: int, rw: int,
               d: int) -> RegStream4Plan:
    """The register-streaming launch at a footprint, its level-0 margin,
    piece, groups and shared memory counted from it (the star's radius 1
    on every side)."""
    BK, BI = bdims[1], bdims[3]
    pw = 4 if BI % 4 == 0 else 1
    h = -(-fuse // pw) * pw
    nq = -(-(pk * BK + 2 * fuse - 2) // REGSTREAM4_ROWS_K)
    one = (1,) * 4
    return RegStream4Plan(ranges, bdims, fuse, one, one, table_k, batch, wch,
                          pk, pj, ti, h, pw, d, 0,
                          regstream4_smem(bdims, fuse, wch, pk, pj, rw, nq,
                                          d), rw, nq)


def regstream4_footprint(plan: SweepPlan, wch: int, pk: int, pj: int,
                         ti: int, rw: int, d: int) -> RegStream4Plan:
    """The register-streaming launch of ``plan`` (the 4-D star) at a
    footprint of its own, whether or not the planner takes the body there;
    for measuring the planner's choice against its neighbours and the body
    at shapes it leaves to the ring body.  The C entry point refuses a
    footprint whose items or shared memory do not fit."""
    return _reg4_plan(tuple(plan.bdims), tuple(plan.ranges),
                      plan.table.shape[1], plan.fuse, plan.batch, wch, pk,
                      pj, ti, rw, d)


def regstream_plan_4d(plan: SweepPlan) -> RegStream4Plan | None:
    """Kernel K4's launch through its register-streaming body, or None
    where that body does not take the sweep: it takes the 4-D star's taps
    (mpi9pt: ``csrc/tap_layouts.cuh``'s ``LayoutStar9``) at ``fuse`` in
    :data:`REGSTREAM4_FUSE`, F radii within a brick, at the footprint (w
    chunk, k brick rows, pencils of at most :data:`REGSTREAM4_ROWS_J` j
    rows, an i tile of 32 lanes and up or the whole brick row and its
    compiled row width, lookahead) of least estimated cost over waves of
    one block an SM whose shared memory fits :data:`K4_SMEM_BUDGET` and
    whose items fit the threads."""
    if (plan.taps is None or plan.fuse not in REGSTREAM4_FUSE
            or plan.taps.offsets.tolist() != _layouts(K4_LAYOUTS)[0]):
        return None
    return _regstream_plan_4d(tuple(plan.bdims), tuple(plan.ranges),
                              plan.table.shape[1], plan.fuse, plan.batch,
                              K4_SMEM_BUDGET)


def k4_launch(plan: SweepPlan) -> Stream4Plan:
    """K4's launch of ``plan``: through its register-streaming body where
    :func:`regstream_plan_4d` plans one, else through its ring body as
    :func:`stream_plan_4d` plans it."""
    return regstream_plan_4d(plan) or stream_plan_4d(plan)


def pencil_sweep_4d_kernel(x: torch.Tensor, table: torch.Tensor,
                           plan: SweepPlan) -> torch.Tensor:
    """Launch kernel K4 on CUDA tensors at :func:`k4_launch`'s launch;
    returns a fresh output whose unwritten bricks are undefined."""
    # checked first: the planners read the taps a nonlinear stencil lacks
    _check_k4_args(x, table, plan)
    lp = k4_launch(plan)
    if lp.body == "regstream":
        return launch_regstream_4d(x, table, plan, lp)
    return launch_4d(x, table, plan, None)


def _check_k4_args(x: torch.Tensor, table: torch.Tensor,
                   plan: SweepPlan) -> None:
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("kernel K4 takes storage and table on one CUDA "
                         f"device, got {x.device} and {table.device}")
    if plan.taps is None:
        raise not_ported("a nonlinear 4-D stencil on a CUDA tensor",
                         FEATURES_ITEM)
    BW, BK, BJ, BI = plan.bdims
    GW, GK, GJ = plan.table.shape
    if (x.dtype != torch.float32 or x.dim() != 5
            or tuple(x.shape[1:]) != plan.bdims or not x.is_contiguous()):
        raise ValueError(f"storage must be contiguous float32 [nb, {BW}, "
                         f"{BK}, {BJ}, {BI}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if (table.dtype != torch.int32 or tuple(table.shape) != (GW, GK, GJ)
            or not table.is_contiguous()):
        raise ValueError(f"table must be contiguous int32 [{GW}, {GK}, "
                         f"{GJ}]")
    if len(plan.taps.coeffs) > 128:
        raise ValueError("kernel K4 takes at most 128 taps")


def launch_regstream_4d(x: torch.Tensor, table: torch.Tensor,
                        plan: SweepPlan, rp: RegStream4Plan) -> torch.Tensor:
    """K4 through its register-streaming body at ``rp``'s footprint
    (:func:`regstream_plan_4d`'s, or another of the same plan; the C entry
    point refuses one whose shared memory is short).
    ``launch_regstream_4d.launches`` counts its launches, the program's
    counter ``k4_regstream``; each is a K4 launch too."""
    _check_k4_args(x, table, plan)
    if rp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K4 takes at most 2^31 - 1 blocks")
    BW, BK, BJ, BI = plan.bdims
    GW, GK, GJ = plan.table.shape
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    # 16-byte pieces need 16-byte aligned storage (a view may start anywhere)
    pw = rp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_pencil_sweep_regstream_4d(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        GW, GK, GJ, BW, BK, BJ, BI, W0, W1, K0, K1, J0, J1, plan.fuse,
        plan.batch, plan.batch_stride, rp.wch, rp.pk, rp.pj, rp.ti, rp.rw,
        rp.nq, rp.h, pw, rp.d, len(coeffs), offs.ctypes.data,
        coeffs.ctypes.data, rp.smem_bytes, _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_regstream_4d")
    pencil_sweep_4d_kernel.launches += 1
    launch_regstream_4d.launches += 1
    return out


launch_regstream_4d.launches = 0


def launch_4d(x: torch.Tensor, table: torch.Tensor, plan: SweepPlan,
              sp: Stream4Plan | None) -> torch.Tensor:
    """K4's ring body at ``sp``'s footprint (``None``: the planner's
    :func:`stream_plan_4d`).  The shared memory is counted again from the
    footprint, so no launch takes less than its layout needs."""
    _check_k4_args(x, table, plan)
    BW, BK, BJ, BI = plan.bdims
    GW, GK, GJ = plan.table.shape
    sp = (stream_plan_4d(plan) if sp is None
          else stream4_footprint(plan, sp.wch, sp.pk, sp.pj, sp.ti, sp.d,
                                 sp.skew))
    if sp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K4 takes at most 2^31 - 1 blocks")
    if sp.smem_bytes > K4_SMEM_BUDGET:
        raise ValueError(f"a K4 block of {sp.smem_bytes} bytes of shared "
                         f"memory exceeds {K4_SMEM_BUDGET}")
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    (wlo, klo, jlo, ilo), (whi, khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    # 16-byte pieces need 16-byte aligned storage (a view may start anywhere)
    pw = sp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_pencil_sweep_4d(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        GW, GK, GJ, BW, BK, BJ, BI, W0, W1, K0, K1, J0, J1, plan.fuse,
        wlo, whi, klo, khi, jlo, jhi, ilo, ihi, plan.batch,
        plan.batch_stride, sp.wch, sp.pk, sp.pj, sp.ti, sp.h, pw, sp.d,
        sp.skew, len(coeffs), offs.ctypes.data, coeffs.ctypes.data,
        sp.smem_bytes, K4_THREADS, _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_4d")
    pencil_sweep_4d_kernel.launches += 1
    return out


pencil_sweep_4d_kernel.launches = 0


def pencil_sweep_4d(stencil, grid: np.ndarray,
                    bdims: Sequence[int],
                    nbricks: int,
                    params: dict | None = None,
                    w_range: tuple[int, int] | None = None,
                    k_range: tuple[int, int] | None = None,
                    j_range: tuple[int, int] | None = None,
                    tile_j: int | None = None,
                    dtype=torch.float32,
                    compute_dtype=torch.float32,
                    interpret: bool | None = None,
                    fuse: int = 1,
                    lookahead: int = 1,
                    vmem_limit_bytes: int = 110 * 2 ** 20,
                    batch: int = 1,
                    batch_stride: int | None = None):
    """Build a 4-D pencil sweep over the grid bricks ``w_range`` x
    ``k_range`` x ``j_range`` (half-open, grid coordinates; default: skip
    one ghost ring per axis); returns ``fn(dat_view) -> out_view`` on
    ``[nbricks, BW, BK, BJ, BI]`` storage.  ``grid`` is ``(GW, GK, GJ)``
    or ``(GW, GK, GJ, 1)``.  ``batch`` > 1 with ``batch_stride`` bricks
    per member sweeps a stack of storages in one launch (the ranks of a
    card), as the 3-D sweep's ``batch`` does.

    Arguments and errors follow ``pallas_pencil_sweep_4d``
    (``bricklib_tpu/codegen/pencil_kernel_4d.py:48``).  Multi-input
    stencils and storage or compute types other than float32 raise
    ``NotImplementedError``; a nonlinear stencil runs on CPU tensors
    only."""
    ir = as_ir(stencil)
    if ir.dims != 4:
        raise NotImplementedError("this path is 4-D; use pencil_kernel "
                                  "for 3-D")
    fieldnames = list(ir.sdef.inputs)
    if not fieldnames:
        raise ValueError("stencil reads no input grid")
    if len(fieldnames) > 1:
        raise not_ported("multi-input 4-D stencils", FEATURES_ITEM)
    BW, BK, BJ, BI = (int(b) for b in bdims)
    grid = np.asarray(grid)
    if grid.ndim == 4:
        if grid.shape[3] != 1:
            raise ValueError("pencil layout needs one brick per (w,k,j)")
        grid = grid[:, :, :, 0]
    GW, GK, GJ = grid.shape
    ranges = []
    for r, n in ((w_range, GW), (k_range, GK), (j_range, GJ)):
        ranges.append((1, n - 1) if r is None else tuple(int(v) for v in r))
    lo, hi = ir.radius()
    if lo[0] > BW or hi[0] > BW or lo[1] > BK or hi[1] > BK \
            or lo[2] > BJ or hi[2] > BJ:
        raise ValueError("stencil radius exceeds brick dims")
    F = int(fuse)
    if F < 1:
        raise ValueError("fuse must be >= 1")
    if F > 1:
        if F * lo[0] > BW or F * hi[0] > BW:
            raise ValueError(f"fuse {F} x w-radius exceeds the brick "
                             f"w depth (BW={BW})")
        if F * lo[1] > BK or F * hi[1] > BK:
            raise ValueError(f"fuse {F} x k-radius exceeds the brick "
                             f"row depth (BK={BK})")
        if F * lo[2] > BJ or F * hi[2] > BJ:
            raise ValueError(f"fuse {F} x j-radius exceeds the "
                             f"one-pencil window halo (BJ={BJ})")
    if int(lookahead) < 1:
        raise ValueError("lookahead must be >= 1")
    JC = ranges[2][1] - ranges[2][0]
    if tile_j is not None and JC % int(tile_j):
        raise ValueError(f"tile_j {int(tile_j)} must divide computed j "
                         f"extent {JC}")
    for (R0, R1), n, name in zip(ranges, (GW, GK, GJ), "wkj"):
        if not 0 <= R0 < R1 <= n:
            raise ValueError(f"{name}_range {(R0, R1)} outside grid extent "
                             f"{n}")
    if not (_is_f32(dtype) and _is_f32(compute_dtype)):
        raise not_ported("storage or compute types other than float32",
                         FEATURES_ITEM)
    batch = int(batch)
    if batch > 1 and batch_stride is None:
        raise ValueError("batch > 1 needs batch_stride (bricks per member)")
    plan = SweepPlan(
        bdims=(BW, BK, BJ, BI), table=np.ascontiguousarray(grid, np.int32),
        ranges=tuple(ranges), fuse=F,
        lo=tuple(int(v) for v in lo), hi=tuple(int(v) for v in hi),
        taps=(params_from_reference(params, ir) if ir.linear is not None
              else None),
        ir=ir, params=dict(params or {}), batch=batch,
        batch_stride=int(batch_stride) if batch > 1 else 0)
    # the span names the body the card runs (k4_launch's choice, without
    # planning the ring body)
    body = "regstream" if regstream_plan_4d(plan) is not None else "stream"
    return sweep_fn(plan, nbricks, pencil_sweep_4d_kernel, "K4", body=body)
