"""The fused pencil sweep on PyTorch (port of
``bricklib_tpu/codegen/pencil_kernel.py``).

:func:`pencil_sweep` has the meaning of the reference's
``pallas_pencil_sweep``: storage ``[nbricks, BK, BJ, BI]`` is read through
a grid table ``T[GK, GJ]`` with one pencil brick (the whole i extent) per
(k, j) cell; the sweep computes the brick rows ``k_range`` x pencils
``j_range`` and applies ``fuse`` = F stencil iterations per pass over
device memory.  The semantics, which :func:`pencil_sweep_plain` spells out
and kernel K1 (``csrc/pencil_sweep.cu``, launched as
:meth:`SweepPlan.stream` plans it) reproduces:

- level 0 at element (kk, jj, i) is ``X[T[clip(kk // BK), clip(jj // BJ)],
  kk % BK, jj % BJ, i]``: rows and pencils beyond the table clamp to the
  edge brick, whole bricks at a time;
- level f (1..F) is the stencil of level f-1, periodic in i modulo BI,
  with no clamp in j;
- after each intermediate level, rows outside ``[0, GK * BK)`` are replaced
  by the clamped row of the same level at the same in-brick offset;
- level F is written to the bricks ``T[K0:K1, J0:J1]``.  Every other
  brick of the output (ghost ring, brick 0) is undefined, as on the TPU.

``batch`` = B > 1 sweeps B subdomains stacked along the brick axis (the
strong-scaling layout): subdomain ``s`` reads and writes through the same
table with ``s * batch_stride`` added to every brick id.

An i-bricked table ``T[GK, GJ, GI]`` (GI > 1, cubic subdomains) has
bricks of ``BI`` lanes along i as well, ``i_ghost`` rings of them in i:
level 0 at lane i reads brick column ``clip(i // BI)`` at ``i % BI``, as
in k and j; every level shrinks by the radius in i with no clamp, as in j
(nothing wraps); level F is written to the bricks ``T[K0:K1, J0:J1,
I0:I1]``, ``i_range`` (default: the i-ghost ring skipped; ``(0, GI)``:
the ghost-inclusive sweep, reading past the table as the reference pads).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches K1
or raises.  The TPU scheduling arguments (``tile_j``, ``lookahead``,
``wait_late``, ``j_shift``, ``vmem_limit_bytes``, ``interpret``) are
checked as the reference checks them and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..core import not_ported
from .evaluate import TorchNS, evaluate, resolve_const_from_params
from .ir import StencilIR
from .taps import TapTable, as_ir, params_from_reference

FEATURES_ITEM = "remaining pencil_sweep features"
# K1's k-streaming blocks (csrc/pencil_stream.cuh; K11's sweep blocks
# too) on the H100: threads per block, the shared memory one block may take
# (227 KB) and one SM holds
# (228 KB, 1 KB of it reserved per resident block), and the SMs to fill
STREAM_THREADS = 512
# output rows a thread computes at once (BT_UR in pencil_stream.cuh)
STREAM_ROWS = 4
STREAM_SMEM_BUDGET = 232448
SM_SMEM, SM_BLOCK_RESERVE, SM_THREADS, SM_COUNT = 233472, 1024, 2048, 132
# the planner's costs, in shared-memory accesses of a tap (an SM makes ~32 a
# clock): one level-0 float loaded (through L2 or from device memory), a
# step's fixed work (its level-0 issue, barrier and per-level set-up), one
# barrier between levels, and a block's start (its brick table and the
# first planes' latency).  The step's cost is fitted to s7pt fuse=4 sweeps
# of 512^3 on the H100 (bench/k1_regimes.py --footprints): it makes the
# widest footprint that fills whole waves of SMs the cheapest.
LOAD_COST, STEP_COST, SYNC_COST, BLOCK_COST = 2, 49152, 4096, 65536
MAX_PENCILS = 8
PLANE_SPAN = 1 << 20
# the tap layouts K1 compiles in (csrc/tap_layouts.cuh): under one, the
# taps' offsets are compile-time constants and a value several taps and
# rows read is one load
STREAM_LAYOUTS = ("s7pt", "mpi125pt")
# K1's register-streaming body (csrc/pencil_regstream.cuh): the star's
# taps at these fused depths, these compiled row widths (a plane's
# columns, the i tile and its margins), threads per block and (quad,
# column) items a thread owns (every level's last two planes of two items
# take the 128 registers a thread that one block an SM leaves)
REGSTREAM_FUSE = (2, 3, 4)
REGSTREAM_ROW_WIDTHS = (40, 72, 80)
REGSTREAM_THREADS, REGSTREAM_ITEMS = 512, 2
# its planner's costs of an SM's step, in items of one level: a fixed part
# (the barrier, level 0's loads and issue, the output rows), a part per
# level, and one unit per item and level; fitted to the s7pt sweeps of
# 512^3 (fuse 4 and 2) and of the strong stack (fuse 4) on the H100
# (bench/k1_regimes.py --footprints: a step costs 0.86 + F (0.20 + 1.6e-4
# items) us, whatever the chunk)
RS_STEP_COST, RS_LEVEL_COST = 5400, 1200


@lru_cache(maxsize=None)
def _layouts(names: tuple) -> tuple:
    from ..stencils import bench_params

    return tuple(params_from_reference(bench_params(), name).offsets.tolist()
                 for name in names)


def stream_loads(offsets, layouts: tuple = STREAM_LAYOUTS) -> float:
    """Shared-memory loads per output of one level of a streaming sweep
    (K1; K4 with its ``layouts``): under a compiled tap layout, the
    distinct values that :data:`STREAM_ROWS` rows of a column read (the
    rows run along the offsets' second axis: j in K1, k in K4), per row;
    otherwise one per tap."""
    offs = np.asarray(offsets).tolist()
    known = _layouts(tuple(layouts))
    if offs not in known:
        return float(len(offs))
    return _layout_loads(tuple(layouts), known.index(offs))


@lru_cache(maxsize=None)
def _layout_loads(layouts: tuple, n: int) -> float:
    vals = {(o[0], o[1] + u, *o[2:]) for o in _layouts(layouts)[n]
            for u in range(STREAM_ROWS)}
    return len(vals) / STREAM_ROWS


@dataclass(frozen=True)
class StreamPlan:
    """K1's launch as :meth:`SweepPlan.stream` plans it.  The output brick
    rows stream in chunks of ``kch`` rows, ``pj`` pencils and ``ti`` i
    lanes per block, level 0 loaded with an i margin of ``h`` lanes per
    side in pieces of ``pw`` floats, ``d`` planes ahead.  ``edge_lo`` /
    ``edge_hi``: the first / last chunk's levels reach below / above the
    table in k, and each block keeps ``stash_lo`` / ``stash_hi`` floats
    of device memory for the clamp's source planes there.  Bit f of
    ``skew`` (1 <= f < F): levels f and f+1 are skewed by a plane, with no
    barrier between them and a plane more in level f's ring.
    ``smem_bytes`` is the launch's dynamic shared memory; ``body`` names
    the kernel body that runs it."""

    body = "stream"
    ranges: tuple
    bdims: tuple
    batch: int
    kch: int
    pj: int
    ti: int
    h: int
    pw: int
    d: int
    edge_lo: bool
    edge_hi: bool
    stash_lo: int
    stash_hi: int
    skew: int
    smem_bytes: int

    @property
    def nchunk(self) -> int:
        (K0, K1) = self.ranges[0]
        return -(-(K1 - K0) // self.kch)

    @property
    def njg(self) -> int:
        (J0, J1) = self.ranges[1]
        return -(-(J1 - J0) // self.pj)

    @property
    def nit(self) -> int:
        """i tiles: ``ti`` divides a pencil's lanes; on an i-bricked table
        the last tile may end past the written lanes (its blocks write
        none of those)."""
        i0, i1 = lane_span(self.bdims, self.ranges)
        return -(-(i1 - i0) // self.ti)

    @property
    def nstream(self) -> int:
        return self.batch * self.nchunk * self.njg * self.nit

    def stash_total(self) -> int:
        """Floats of the stash the launch needs: one slice per (subdomain,
        pencil group, i tile)."""
        return (self.batch * self.njg * self.nit
                * (self.stash_lo + self.stash_hi))

    def blocks(self) -> list:
        """Every block of the launch in grid order, decoded as the kernel
        decodes it: ``(subdomain, (k0, k1), (j0, j1), (i0, i1), edges)``
        in brick rows, pencils and i lanes; ``edges`` names the table
        edges ("low", "high") the block's chunk handles."""
        (K0, K1), (J0, J1) = self.ranges[:2]
        i0, i1 = lane_span(self.bdims, self.ranges)
        out = []
        for b in range(self.nstream):
            it, b = b % self.nit, b // self.nit
            jg, b = b % self.njg, b // self.njg
            ch, sub = b % self.nchunk, b // self.nchunk
            k0, j0 = K0 + ch * self.kch, J0 + jg * self.pj
            edges = (("low",) * (self.edge_lo and ch == 0)
                     + ("high",) * (self.edge_hi
                                    and ch == self.nchunk - 1))
            out.append((sub, (k0, min(k0 + self.kch, K1)),
                        (j0, min(j0 + self.pj, J1)),
                        (i0 + it * self.ti, min(i0 + (it + 1) * self.ti,
                                                i1)), edges))
        return out


def stash_floats(bdims, fuse: int, lo, hi, pj: int, ti: int,
                 h: int) -> tuple[int, int]:
    """Floats of one block's stash per k edge (low, high): level f's (1 to
    F-1) clamp sources, ``(F - f) * klo`` (``khi``) planes of ``(pj * BJ +
    (F - f) * rj)`` rows of ``ti + 2h`` floats."""
    rj, rw, wjm = lo[1] + hi[1], ti + 2 * h, pj * bdims[1]
    per = [(wjm + (fuse - f) * rj) * rw * (fuse - f)
           for f in range(1, fuse)]
    return lo[0] * sum(per), hi[0] * sum(per)


def lane_span(bdims, ranges) -> tuple[int, int]:
    """A sweep's output i lanes: the pencil brick's, or on an i-bricked
    table (a third range) the written i bricks'."""
    if len(ranges) > 2:
        return ranges[2][0] * bdims[2], ranges[2][1] * bdims[2]
    return 0, bdims[2]


def ib_cols(lanes: int, bi: int) -> int:
    """Brick columns a run of ``lanes`` lanes may touch on an i-bricked
    table, starting anywhere in a brick of ``bi`` lanes (``ib_cols`` in
    ``pencil_stream.cuh``)."""
    return -(-lanes // bi) + 1


def brick_cols(bdims, ti: int, h: int, ib: bool) -> tuple[int, int]:
    """Brick columns a block's tables keep per (brick row, pencil): a
    level-0 row's (``ti + 2h`` lanes) and an output row's (``ti``); one
    each on the pencil layout."""
    if not ib:
        return 1, 1
    return ib_cols(ti + 2 * h, bdims[2]), ib_cols(ti, bdims[2])


def stream_smem(bdims, fuse: int, lo, hi, kch: int, pj: int, ti: int,
                h: int, d: int, skew: int = 0, ib: bool = False) -> int:
    """Dynamic shared memory of one k-streaming block, laid out as
    ``pencil_stream.cuh`` lays it out: the level-0 ring (``rk + 1 + d``
    planes), the rings of levels 1 to F-1 (``rk + 1`` planes each, one
    more where ``skew`` has the level's bit), every
    plane ``(pj * BJ + (F - f) * rj)`` rows of ``ti + 2h`` floats, ``h``
    floats before them and :func:`stream_slack` after, the count rounded
    up to even; then the brick table (``(kch + 2) x (pj + 2)`` 64-bit
    offsets, times a level-0 row's brick columns on an i-bricked table,
    ``ib``), two ints per level-0 row and two buffers of ``pj * BJ``
    64-bit output row offsets (times an output row's brick columns)."""
    _, BJ, _ = bdims
    rk, rj = lo[0] + hi[0], lo[1] + hi[1]
    rw, wjm = ti + 2 * h, pj * BJ
    nibm, nob = brick_cols(bdims, ti, h, ib)
    n = (rk + 1 + d) * (wjm + fuse * rj) * rw
    n += sum((rk + 1 + (skew >> f & 1)) * (wjm + (fuse - f) * rj) * rw
             for f in range(1, fuse))
    n = (h + n + stream_slack(rw, h, BJ) + 1) & ~1
    return (4 * n + 8 * (kch + 2) * (pj + 2) * nibm
            + 8 * (wjm + fuse * rj) + 16 * wjm * nob)


def stream_slack(rw: int, h: int, bj: int) -> int:
    """Floats after the rings that a level may read past its source plane
    (``stream_slack`` in ``pencil_stream.cuh``): a tap's reach and 32
    lanes, and with bricks less than :data:`STREAM_ROWS` deep in j a
    quad's rows beyond a block's."""
    return h + 40 + max(STREAM_ROWS - bj, 0) * rw


def tile_widths(bdims, ranges, pw: int) -> list:
    """The i tiles a planner tries: the divisors of a pencil's lanes that
    are whole pieces; on an i-bricked table (a third range) the widths
    that cut the written lanes into n tiles of whole pieces with the
    least left over, for every n."""
    BI = bdims[2]
    if len(ranges) < 3:
        return [t for t in range(pw, BI + 1, pw) if BI % t == 0]
    i0, i1 = lane_span(bdims, ranges)
    return sorted({-(-(i1 - i0) // (n * pw)) * pw
                   for n in range(1, (i1 - i0) // pw + 1)})


@lru_cache(maxsize=256)
def _stream_plan(bdims, ranges, table_k: int, fuse: int, lo, hi,
                 batch: int, ntaps: int, loads: float | None = None,
                 budget: int = STREAM_SMEM_BUDGET) -> StreamPlan:
    BK, BJ, BI = bdims
    (K0, K1), (J0, J1) = ranges[:2]
    ib = len(ranges) > 2
    i0, i1 = lane_span(bdims, ranges)
    iw = i1 - i0
    F = fuse
    edge_lo = K0 == 0 and lo[0] > 0
    edge_hi = K1 == table_k and hi[0] > 0
    if F > 1 and (edge_lo or edge_hi) and table_k < 2:
        raise ValueError("kernel K1 clamps k at the table's edges on tables "
                         f"of two brick rows or more, got {table_k}")
    nrows, npen = K1 - K0, J1 - J0
    pw = 4 if BI % 4 == 0 else 1
    h = -(-F * max(lo[2], hi[2]) // pw) * pw
    rk, rj, ri = (a + b for a, b in zip(lo, hi))
    # a chunk's planes from its first brick row stay below 2^20 (the
    # kernel's division-free ring slots; BT_PLANE_SPAN)
    chunks = sorted(c for c in {-(-nrows // n) for n in range(1, nrows + 1)}
                    if (c + 2) * BK + F * (lo[0] + hi[0] + 1)
                    < PLANE_SPAN)
    # a lone level of few taps is bound by device memory: two planes ahead
    lookaheads = (2,) if F == 1 and ntaps < 40 else (2, 1)
    # skewed level boundaries: the top m of them (the highest levels' rings
    # are the smallest, so their extra planes cost the least)
    skews = [((1 << F) - 1) ^ ((1 << (F - m)) - 1) for m in range(F)]
    # shared-memory accesses per element of a level: its loads (one per tap
    # without a compiled layout), one store, a tap's address per quad
    per_elem = (ntaps if loads is None else loads) + 1 + ntaps / STREAM_ROWS

    def quads(rows: int) -> int:
        return -(-rows // STREAM_ROWS) * STREAM_ROWS

    best = None
    for ti in tile_widths(bdims, ranges, pw):
        rw = ti + 2 * h
        for pj in range(1, min(npen, MAX_PENCILS) + 1):
            wj = pj * BJ
            for kch in chunks:
                L = kch * BK
                # levels 1 to F-1 over whole rows of rw columns, level F
                # over 32-lane chunks of the output lanes, in quads of rows
                ucf = -(-ti // 32)
                work = (LOAD_COST * (wj + F * rj) * rw * (L + F * rk)
                        + (sum(quads(wj + (F - f) * rj) * rw
                               * (L + (F - f) * rk) for f in range(1, F))
                           + quads(wj) * ucf * 32 * L) * per_elem)
                nblocks = (batch * -(-nrows // kch) * -(-npen // pj)
                           * -(-iw // ti))
                for d, skew in ((d, m) for d in lookaheads for m in skews):
                    smem = stream_smem(bdims, F, lo, hi, kch, pj, ti, h, d,
                                       skew, ib)
                    if smem > budget:
                        continue
                    # per step its fixed work and a barrier per unskewed
                    # level boundary
                    nsk = bin(skew).count("1")
                    stall = ((L + F * rk + nsk)
                             * (STEP_COST + (F - 1 - nsk) * SYNC_COST)
                             + BLOCK_COST)
                    bps = min(SM_SMEM // (smem + SM_BLOCK_RESERVE),
                              SM_THREADS // STREAM_THREADS)
                    waves = -(-nblocks // (SM_COUNT * bps))
                    # an SM runs its bps blocks side by side: a wave takes
                    # bps blocks' work, and one block's barriers and start
                    # (the others' work fills them); lookahead 2 breaks ties
                    cost = (waves * (bps * work + stall), -d, -ti, kch)
                    if best is None or cost < best[0]:
                        best = (cost, (kch, pj, ti, d, skew, smem))
    if best is None:
        raise ValueError(f"no k-streaming block of bricks {bdims} fits "
                         f"{budget} bytes of shared memory at "
                         f"fuse={F}")
    kch, pj, ti, d, skew, smem = best[1]
    st_lo, st_hi = stash_floats(bdims, F, lo, hi, pj, ti, h)
    return StreamPlan(ranges, bdims, batch, kch, pj, ti, h, pw, d, edge_lo,
                      edge_hi, st_lo * edge_lo, st_hi * edge_hi, skew, smem)


@dataclass(frozen=True)
class RegStreamPlan(StreamPlan):
    """K1's launch through its register-streaming body, as
    :meth:`SweepPlan.regstream` plans it: the blocks are decoded as the
    ring body's (:meth:`StreamPlan.blocks`), with no skewed levels; every
    level plane is ``nq`` quads of rows of ``rw`` columns (the compiled row
    width, ``ti + 2h`` and up), and each block's stash per edge holds every
    thread's items at the clamp's source planes."""

    body = "regstream"
    rw: int
    nq: int


def regstream_smem(bdims, fuse: int, kch: int, pj: int, rw: int, nq: int,
                   d: int, cols: tuple = (1, 1)) -> int:
    """Dynamic shared memory of one register-streaming block, laid out as
    ``pencil_regstream.cuh`` lays it out: ``d + 3`` level-0 planes and two
    of each of levels 1 to F-1, every plane ``nq`` quads of 4 rows of
    ``rw`` floats and a pad, the row above the first quad before them and
    ``rw`` floats after, the count rounded up to even; then the brick
    table, two ints per level-0 row and two buffers of the output rows'
    offsets (as :func:`stream_smem`; ``cols``: :func:`brick_cols`)."""
    wjm = pj * bdims[1]
    pad = (32 - 3 * rw % 32) % 32
    planes = d + 3 + 2 * (fuse - 1)
    n = (rw + pad + planes * nq * (4 * rw + pad) + rw + 1) & ~1
    return (4 * n + 8 * (kch + 2) * (pj + 2) * cols[0]
            + 8 * (wjm + 2 * fuse) + 16 * wjm * cols[1])


def regstream_stash_floats(fuse: int) -> int:
    """Floats of one register-streaming block's stash per k edge: level
    f's (1 to F-1) ``F - f`` clamp source planes, one float per thread,
    item and row of each."""
    return (fuse * (fuse - 1) // 2 * REGSTREAM_THREADS * REGSTREAM_ITEMS
            * STREAM_ROWS)


@lru_cache(maxsize=256)
def _regstream_plan(bdims, ranges, table_k: int, fuse: int, batch: int):
    BK, BJ, BI = bdims
    (K0, K1), (J0, J1) = ranges[:2]
    ib = len(ranges) > 2
    i0, i1 = lane_span(bdims, ranges)
    iw = i1 - i0
    F = fuse
    edge_lo, edge_hi = K0 == 0, K1 == table_k
    if (F not in REGSTREAM_FUSE or F > BK or F > BJ
            or ((edge_lo or edge_hi) and table_k < 2)):
        return None
    nrows, npen = K1 - K0, J1 - J0
    pw = 4 if BI % 4 == 0 else 1
    h = -(-F // pw) * pw
    chunks = sorted(c for c in {-(-nrows // n) for n in range(1, nrows + 1)}
                    if (c + 2) * BK + 3 * F < PLANE_SPAN)
    best = None
    for ti in tile_widths(bdims, ranges, pw):
        rw = min((w for w in REGSTREAM_ROW_WIDTHS if w >= ti + 2 * h),
                 default=None)
        if rw is None:
            continue
        for pj in range(1, min(npen, MAX_PENCILS) + 1):
            nq = -(-(pj * BJ + 2 * F) // STREAM_ROWS)
            if nq * rw > REGSTREAM_THREADS * REGSTREAM_ITEMS:
                continue
            # an SM's step: one block an SM (its registers)
            step = RS_STEP_COST + F * (RS_LEVEL_COST + nq * rw)
            for kch in chunks:
                nblocks = (batch * -(-nrows // kch) * -(-npen // pj)
                           * -(-iw // ti))
                waves = -(-nblocks // SM_COUNT)
                for d in (2, 1):
                    smem = regstream_smem(bdims, F, kch, pj, rw, nq, d,
                                          brick_cols(bdims, ti, h, ib))
                    if smem > STREAM_SMEM_BUDGET:
                        continue
                    cost = (waves * (kch * BK + 2 * F) * step, -d, -ti, kch)
                    if best is None or cost < best[0]:
                        best = (cost, (kch, pj, ti, rw, nq, d, smem))
    if best is None:
        return None
    kch, pj, ti, rw, nq, d, smem = best[1]
    st = regstream_stash_floats(F)
    return RegStreamPlan(ranges, bdims, batch, kch, pj, ti, h, pw, d,
                         edge_lo, edge_hi, st * edge_lo, st * edge_hi, 0,
                         smem, rw, nq)


@dataclass(frozen=True)
class SweepPlan:
    """Everything static about one sweep: brick shape ``bdims`` (outer
    axes, then i), table (one brick id per outer cell), the half-open
    output ``ranges`` per outer axis, fused levels, radius per side (numpy
    axis order), either the linear tap table (``taps``) or, for a
    nonlinear stencil, its IR and resolver, and the batch: ``batch``
    subdomains share the table, subdomain ``s`` adding ``s *
    batch_stride`` to every brick id.  ``fields`` names the input grids of
    a multi-input stencil in the order the sweep takes them (empty for
    one input).  The 3-D sweep has outer axes (k, j), the 4-D sweep (w,
    k, j), the rank-``nd`` sweep ``nd - 1`` of them."""

    bdims: tuple
    table: np.ndarray
    ranges: tuple
    fuse: int
    lo: tuple
    hi: tuple
    taps: TapTable | None
    ir: StencilIR
    params: dict
    batch: int = 1
    batch_stride: int = 0
    fields: tuple = ()

    @property
    def ibrick(self) -> bool:
        """The table has an i axis of bricks (``[GK, GJ, GI]`` for 3-D
        bricks; ``ranges`` then has a third, i range)."""
        return self.table.ndim == len(self.bdims)

    def written_bricks(self) -> np.ndarray:
        """Storage ids this sweep writes (sorted, unique)."""
        ids = self.table[tuple(slice(a, b) for a, b in self.ranges)]
        return np.unique(np.concatenate(
            [ids.ravel() + s * self.batch_stride
             for s in range(self.batch)]))

    def stream(self) -> StreamPlan:
        """Kernel K1's launch (3-D, linear taps): the block footprint (k
        chunk, pencils, i tile, lookahead) of least estimated cost,
        shared-memory accesses and level-0 loads per wave of blocks over
        :data:`SM_COUNT` SMs, whose shared memory fits
        :data:`STREAM_SMEM_BUDGET`, and the stash of the chunks at the
        table's k edges."""
        return _stream_plan(tuple(self.bdims), tuple(self.ranges),
                            self.table.shape[0], self.fuse, tuple(self.lo),
                            tuple(self.hi), self.batch,
                            len(self.taps.coeffs),
                            stream_loads(self.taps.offsets))

    def regstream(self) -> RegStreamPlan | None:
        """Kernel K1's launch through its register-streaming body, or None
        where that body does not take the sweep: it takes the star's taps
        (s7pt, mpi7pt: ``csrc/tap_layouts.cuh``'s ``LayoutStar7``) at
        ``fuse`` in :data:`REGSTREAM_FUSE`, at the footprint (k chunk,
        pencils, i tile and its compiled row width, lookahead) of least
        estimated cost over waves of one block an SM."""
        if (self.taps is None or self.fuse not in REGSTREAM_FUSE
                or self.taps.offsets.tolist() != _layouts(("s7pt",))[0]):
            return None
        return _regstream_plan(tuple(self.bdims), tuple(self.ranges),
                               self.table.shape[0], self.fuse, self.batch)


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def _apply_level(srcs: list, plan: SweepPlan) -> torch.Tensor:
    """One stencil iteration on dense ``[batch, *outer, i]`` levels, one
    per input field; the result is smaller by the radius on each side of
    every outer axis, and of i on an i-bricked table; on the pencil layout
    it is periodic in i.  Taps add in tap order."""
    lo, hi = plan.lo, plan.hi
    no = len(plan.bdims) - 1
    ng = plan.table.ndim                     # the axes that shrink
    sizes = [srcs[0].shape[1 + a] - lo[a] - hi[a] for a in range(ng)]

    def shifted(f, offs):
        v = srcs[f][(slice(None),) + tuple(
            slice(lo[a] + offs[a], lo[a] + offs[a] + sizes[a])
            for a in range(ng))]
        if ng > no or not offs[no]:
            return v
        return torch.roll(v, -offs[no], dims=no + 1)

    if plan.taps is None:
        def read_tap(name, offs_edsl):
            f = plan.fields.index(name) if plan.fields else 0
            return shifted(f, [int(offs_edsl[no - a])
                               for a in range(no + 1)])

        out = evaluate(plan.ir.sdef.rhs, read_tap,
                       resolve_const_from_params(plan.params), TorchNS)
        return out.to(srcs[0].dtype)
    inputs = (plan.taps.inputs.tolist() if plan.taps.inputs is not None
              else [0] * len(plan.taps.coeffs))
    acc = None
    for offs, c, f in zip(plan.taps.offsets.tolist(),
                          plan.taps.coeffs.tolist(), inputs):
        t = c * shifted(f, offs)
        acc = t if acc is None else acc + t
    return acc


def pencil_sweep_plain(x, table: torch.Tensor,
                       plan: SweepPlan) -> torch.Tensor:
    """The plain PyTorch version of kernels K1 (3-D), K4 (4-D) and K12
    (rank 5 and above), on any device: the levels as dense ``[batch,
    *outer, i]`` tensors over the output ranges grown by the radius.
    Level 0 clamps whole bricks at the table edge in every outer axis
    (and in i on an i-bricked table); after each intermediate level the k
    rows outside the table take the clamped row's values.  ``x`` is the
    storage, or for a multi-input stencil (``fuse=1``) one storage per
    name of ``plan.fields``."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if len(xs) > 1 and plan.fuse != 1:
        raise ValueError("a multi-input sweep applies one level")
    x = xs[0]
    bd = plan.bdims
    no = len(bd) - 1
    ng = plan.table.ndim                     # the axes read through bricks
    G = plan.table.shape
    F = plan.fuse
    dev = x.device
    ids = table.long()
    offs = []
    for a, (R0, R1) in enumerate(plan.ranges):
        c = torch.arange(R0 * bd[a] - F * plan.lo[a],
                         R1 * bd[a] + F * plan.hi[a], device=dev)
        b = torch.div(c, bd[a], rounding_mode="floor")
        shape = [1] * ng
        shape[a] = -1
        ids = ids.index_select(a, b.clamp(0, G[a] - 1))
        offs.append((c - b * bd[a]).reshape(shape))
    strides = torch.arange(plan.batch, device=dev) * plan.batch_stride
    ids = ids[None] + strides.reshape((-1,) + (1,) * ng)
    levels = [xi[(ids,) + tuple(o[None] for o in offs)] for xi in xs]
    ka = no - 2                              # the k axis among the outer
    BK, GK, K0 = bd[ka], G[ka], plan.ranges[ka][0]
    for f in range(1, F + 1):
        level = _apply_level(levels, plan)
        kbase = K0 * BK - (F - f) * plan.lo[ka]
        nk = level.shape[1 + ka]
        if f < F and (kbase < 0 or kbase + nk > GK * BK):
            rows = torch.arange(kbase, kbase + nk, device=dev)
            rb = torch.div(rows, BK, rounding_mode="floor")
            level = level.index_select(
                1 + ka, rb.clamp(0, GK - 1) * BK + rows - rb * BK - kbase)
        levels = [level]
    counts = [R1 - R0 for R0, R1 in plan.ranges]
    split = [plan.batch]
    for c, b in zip(counts, bd[:ng]):
        split += [c, b]
    perm = ([0] + [1 + 2 * a for a in range(ng)]
            + [2 + 2 * a for a in range(ng)] + [1 + 2 * ng] * (ng == no))
    vals = level.reshape(split + [bd[no]] * (ng == no)).permute(
        perm).reshape((-1,) + tuple(bd))
    wids = table[tuple(slice(R0, R1) for R0, R1 in plan.ranges)].long()
    wids = (wids[None] + strides.reshape((-1,) + (1,) * ng)).reshape(-1)
    out = torch.empty_like(x)
    out[wids] = vals
    return out


def k1_launch(plan: SweepPlan) -> StreamPlan:
    """K1's launch of ``plan``: through its register-streaming body where
    :meth:`SweepPlan.regstream` plans one, else through its ring body as
    :meth:`SweepPlan.stream` plans it."""
    return plan.regstream() or plan.stream()


def pencil_sweep_kernel(x: torch.Tensor, table: torch.Tensor,
                        plan: SweepPlan) -> torch.Tensor:
    """Launch kernel K1 on CUDA tensors at :func:`k1_launch`'s launch;
    returns a fresh output whose unwritten bricks are undefined."""
    # checked first: the planners read the taps a nonlinear stencil lacks
    _check_k1_args(x, table, plan)
    lp = k1_launch(plan)
    if lp.body == "regstream":
        return launch_regstream(x, table, plan, lp)
    return _launch_stream(x, table, plan, None)


def _check_k1_args(x: torch.Tensor, table: torch.Tensor,
                   plan: SweepPlan) -> None:
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("kernel K1 takes storage and table on one CUDA "
                         f"device, got {x.device} and {table.device}")
    if plan.taps is None:
        raise not_ported("a nonlinear stencil on a CUDA tensor",
                         FEATURES_ITEM)
    BK, BJ, BI = plan.bdims
    shape = tuple(plan.table.shape)
    if (x.dtype != torch.float32 or x.dim() != 4
            or tuple(x.shape[1:]) != (BK, BJ, BI) or not x.is_contiguous()):
        raise ValueError(f"storage must be contiguous float32 [nb, {BK}, "
                         f"{BJ}, {BI}], got {x.dtype} {tuple(x.shape)}")
    if (table.dtype != torch.int32 or tuple(table.shape) != shape
            or not table.is_contiguous()):
        raise ValueError("table must be contiguous int32 "
                         f"{list(shape)}")
    if len(plan.taps.coeffs) > 128:
        raise ValueError("kernel K1 takes at most 128 taps")


def _table_args(plan: SweepPlan) -> tuple:
    """K1's table arguments: ``GK, GJ``, the output ranges in k and j,
    then ``GI`` and the written i bricks (``0, 0, 0`` on the pencil
    layout)."""
    (K0, K1), (J0, J1) = plan.ranges[:2]
    GK, GJ = plan.table.shape[:2]
    gi = ((plan.table.shape[2],) + tuple(plan.ranges[2]) if plan.ibrick
          else (0, 0, 0))
    return (GK, GJ, K0, K1, J0, J1) + gi


def _counted(plan: SweepPlan) -> None:
    """Count a K1 launch, and on an i-bricked table (either body) also in
    ``pencil_sweep_kernel.ibrick_launches``: the program's counter
    ``k1_ibrick``."""
    pencil_sweep_kernel.launches += 1
    if plan.ibrick:
        pencil_sweep_kernel.ibrick_launches += 1


def launch_regstream(x: torch.Tensor, table: torch.Tensor, plan: SweepPlan,
                     rp: RegStreamPlan) -> torch.Tensor:
    """K1 through its register-streaming body at ``rp``'s footprint
    (:meth:`SweepPlan.regstream`'s, or another of the same plan; the C
    entry point refuses one whose shared memory or stash is short).
    ``launch_regstream.launches`` counts its launches, the program's
    counter ``k1_regstream``; each is a K1 launch too."""
    _check_k1_args(x, table, plan)
    if rp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K1 takes at most 2^31 - 1 blocks")
    BK, BJ, BI = plan.bdims
    GK, GJ, K0, K1, J0, J1, GI, I0, I1 = _table_args(plan)
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    stream = _build.stream_handle(x.device)
    stash = _stash(x.device, stream, rp.stash_total())
    pw = rp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_pencil_sweep_regstream(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        None if stash is None else stash.data_ptr(),
        GK, GJ, BK, BJ, BI, K0, K1, J0, J1, GI, I0, I1, plan.fuse,
        plan.batch, plan.batch_stride, rp.kch, rp.pj, rp.ti, rp.rw, rp.nq,
        rp.h, pw, rp.d, int(rp.edge_lo), int(rp.edge_hi), rp.stash_lo,
        rp.stash_hi, len(coeffs), offs.ctypes.data, coeffs.ctypes.data,
        rp.smem_bytes, stream)
    _build.check(err, "pencil_sweep_regstream")
    _counted(plan)
    launch_regstream.launches += 1
    return out


launch_regstream.launches = 0


def _stream_footprint(plan: SweepPlan, kch: int, pj: int, ti: int, d: int,
                      skew: int) -> StreamPlan:
    """The launch of ``plan`` at another footprint (chunk, pencils, i
    tile, lookahead, skewed level boundaries), its shared memory and stash
    counted from that footprint; for measuring the planner's choice
    against its neighbours."""
    sp = plan.stream()
    lo, hi = stash_floats(plan.bdims, plan.fuse, plan.lo, plan.hi, pj, ti,
                          sp.h)
    return StreamPlan(sp.ranges, sp.bdims, sp.batch, kch, pj, ti, sp.h,
                      sp.pw, d, sp.edge_lo, sp.edge_hi, lo * sp.edge_lo,
                      hi * sp.edge_hi, skew,
                      stream_smem(plan.bdims, plan.fuse, plan.lo, plan.hi,
                                  kch, pj, ti, sp.h, d, skew, plan.ibrick))


def _launch_stream(x: torch.Tensor, table: torch.Tensor, plan: SweepPlan,
                   sp: StreamPlan | None) -> torch.Tensor:
    """K1's ring body at ``sp``'s footprint (``None``: the planner's
    :meth:`SweepPlan.stream`).  The shared memory and the stash are
    counted again from the footprint, so no launch takes less than its
    layout needs."""
    _check_k1_args(x, table, plan)
    BK, BJ, BI = plan.bdims
    sp = (plan.stream() if sp is None
          else _stream_footprint(plan, sp.kch, sp.pj, sp.ti, sp.d, sp.skew))
    if sp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K1 takes at most 2^31 - 1 blocks")
    GK, GJ, K0, K1, J0, J1, GI, I0, I1 = _table_args(plan)
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    stream = _build.stream_handle(x.device)
    stash = _stash(x.device, stream, sp.stash_total())
    # 16-byte pieces need 16-byte aligned storage (a view may start anywhere)
    pw = sp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_pencil_sweep(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        None if stash is None else stash.data_ptr(),
        GK, GJ, BK, BJ, BI, K0, K1, J0, J1, GI, I0, I1, plan.fuse,
        klo, khi, jlo, jhi, ilo, ihi, plan.batch, plan.batch_stride,
        sp.kch, sp.pj, sp.ti, sp.h, pw, sp.d, int(sp.edge_lo),
        int(sp.edge_hi), sp.stash_lo, sp.stash_hi, sp.skew, len(coeffs),
        offs.ctypes.data, coeffs.ctypes.data, sp.smem_bytes, STREAM_THREADS,
        stream)
    _build.check(err, "pencil_sweep")
    _counted(plan)
    return out


pencil_sweep_kernel.launches = 0
pencil_sweep_kernel.ibrick_launches = 0

# K1's stash per (device, stream), kept between launches: launches on one
# stream run in order, and a fresh stash per call between the outputs'
# large blocks can make the allocator call cudaMalloc inside a timed loop
_stashes: dict = {}


def _stash(device, stream: int, n: int):
    """A float32 device buffer of at least ``n`` elements for K1's stash
    (None for none)."""
    if n == 0:
        return None
    t = _stashes.get((device, stream))
    if t is None or t.numel() < n:
        t = _stashes[(device, stream)] = torch.empty(
            n, dtype=torch.float32, device=device)
    return t


def pencil_sweep(stencil, grid: np.ndarray,
                 bdims: Sequence[int],
                 nbricks: int,
                 params: dict | None = None,
                 k_range: tuple[int, int] | None = None,
                 j_range: tuple[int, int] | None = None,
                 i_range: tuple[int, int] | None = None,
                 tile_j: int | None = None,
                 dtype=torch.float32,
                 compute_dtype=torch.float32,
                 interpret: bool | None = None,
                 inplace: bool = False,
                 batch: int = 1,
                 batch_stride: int | None = None,
                 fuse: int = 1,
                 i_ghost: int = 0,
                 lookahead: int = 1,
                 evolve=None,
                 wait_late: bool = False,
                 j_shift: str = "slice",
                 vmem_limit_bytes: int = 110 * 2 ** 20):
    """Build a pencil sweep over grid rows ``k_range`` x pencils
    ``j_range`` (half-open, grid coordinates; default: skip the outer
    ring); returns ``fn(dat_view) -> out_view`` on ``[nbricks, BK, BJ,
    BI]`` storage.  ``fuse`` = F applies F stencil iterations per pass.

    Arguments and errors follow ``pallas_pencil_sweep``
    (``bricklib_tpu/codegen/pencil_kernel.py:296``); ``batch`` > 1 with
    ``batch_stride`` bricks per subdomain sweeps every subdomain of the
    stack in one launch.  An i-bricked ``grid`` (``[GK, GJ, GI]``, GI >
    1) needs ``i_ghost`` >= 1 rings of ghost bricks in i; ``i_range``
    (half-open brick columns) defaults to skipping them, and ``(0, GI)``
    sweeps them too (the module's docstring).  ``inplace``, multi-input
    stencils and systems, and bf16 storage raise ``NotImplementedError``;
    a nonlinear stencil runs on CPU tensors only."""
    sdefs = stencil if isinstance(stencil, (list, tuple)) else [stencil]
    if len(sdefs) == 0:
        raise ValueError("empty stencil system")
    if len(sdefs) > 1:
        raise not_ported("stencil systems", FEATURES_ITEM)
    ir = as_ir(sdefs[0])
    if ir.dims != 3:
        raise NotImplementedError("pencil path is 3-D")
    fieldnames = list(ir.sdef.inputs)
    if not fieldnames:
        raise ValueError("stencil reads no input grid")
    if len(fieldnames) > 1:
        raise not_ported("multi-input stencils", FEATURES_ITEM)
    if evolve is not None:
        evolve = (evolve,) if isinstance(evolve, str) else tuple(evolve)
        if len(evolve) != 1 or len(set(evolve)) != 1:
            raise ValueError(f"1 output(s) need 1 distinct evolve "
                             f"name(s), got {evolve}")
        if evolve[0] not in fieldnames:
            raise ValueError(f"evolve field {evolve[0]!r} is not a "
                             f"stencil input ({fieldnames})")
    BK, BJ, BI = (int(b) for b in bdims)
    grid = np.asarray(grid)
    GI = 1
    if grid.ndim == 3:
        GI = grid.shape[2]
        if GI == 1:
            grid = grid[:, :, 0]
    ib = GI > 1
    i_ghost = int(i_ghost)
    if ib and i_ghost < 1:
        raise ValueError("i-bricked layouts (GI > 1) need i_ghost >= 1 "
                         "ghost brick rings in i")
    if not ib and i_range is not None and tuple(i_range) != (0, 1):
        raise ValueError("i_range applies to i-bricked layouts only")
    if ib:
        I0, I1 = ((i_ghost, GI - i_ghost) if i_range is None
                  else (int(i) for i in i_range))
        if i_range is not None and not 0 <= I0 < I1 <= GI:
            raise ValueError(f"i_range {i_range} outside grid i extent "
                             f"{GI}")
    lo, hi = ir.radius()
    GK, GJ = grid.shape[:2]
    if k_range is None:
        k_range = (1, GK - 1)
    if j_range is None:
        j_range = (1, GJ - 1)
    K0, K1 = (int(k) for k in k_range)
    J0, J1 = (int(j) for j in j_range)
    if not (0 <= K0 < K1 <= GK and 0 <= J0 < J1 <= GJ):
        raise ValueError(f"range k{k_range} j{j_range} outside grid "
                         f"({GK}, {GJ})")
    batch = int(batch)
    if batch > 1 and batch_stride is None:
        raise ValueError("batch > 1 needs batch_stride (bricks per "
                         "subdomain)")
    stride = int(batch_stride) if batch > 1 else 0
    if lo[0] > BK or hi[0] > BK or lo[1] > BJ or hi[1] > BJ:
        raise ValueError("stencil radius exceeds brick dims")
    if ib and (lo[2] > BI or hi[2] > BI):
        raise ValueError("stencil i-radius exceeds brick i width")
    F = int(fuse)
    if F < 1:
        raise ValueError("fuse must be >= 1")
    if inplace:
        raise not_ported("inplace partial sweeps", FEATURES_ITEM)
    if F > 1:
        if F * lo[1] > BJ or F * hi[1] > BJ:
            raise ValueError(
                f"fuse {F} x j-radius exceeds the one-pencil window "
                f"halo (BJ={BJ})")
        if F * lo[0] > BK or F * hi[0] > BK:
            raise ValueError(
                f"fuse {F} x k-radius exceeds the brick row depth "
                f"(BK={BK})")
        # a ghost-inclusive range reads one brick past the table (the
        # reference's padded column), an owned one the ghost bricks
        pad_lo = int(I0 == 0 and lo[2] > 0) if ib else 0
        pad_hi = int(I1 == GI and hi[2] > 0) if ib else 0
        if ib and (F * lo[2] > (I0 + pad_lo) * BI
                   or F * hi[2] > (GI - I1 + pad_hi) * BI):
            raise ValueError(
                f"fuse {F} x i-radius exceeds the i window margin "
                f"({(I0 + pad_lo) * BI}, {(GI - I1 + pad_hi) * BI})")
    if int(lookahead) < 1:
        raise ValueError("lookahead must be >= 1")
    if j_shift not in ("slice", "roll"):
        raise ValueError("j_shift is 'slice' or 'roll'")
    if tile_j is not None and (J1 - J0) % int(tile_j):
        raise ValueError(f"tile_j {int(tile_j)} must divide computed j "
                         f"extent {J1 - J0}")
    if not (_is_f32(dtype) and _is_f32(compute_dtype)):
        raise not_ported("storage or compute types other than float32",
                         FEATURES_ITEM)

    plan = SweepPlan(
        bdims=(BK, BJ, BI), table=np.ascontiguousarray(grid, np.int32),
        ranges=((K0, K1), (J0, J1)) + (((I0, I1),) if ib else ()), fuse=F,
        lo=tuple(int(v) for v in lo), hi=tuple(int(v) for v in hi),
        taps=(params_from_reference(params, ir) if ir.linear is not None
              else None),
        ir=ir, params=dict(params or {}), batch=batch, batch_stride=stride)
    # the span names the body the card runs (k1_launch's choice, without
    # planning the ring body) and the table's layout
    body = "regstream" if plan.regstream() is not None else "stream"
    return sweep_fn(plan, nbricks, pencil_sweep_kernel, body=body,
                    layout="ibrick" if ib else "pencil")


def check_table(plan: SweepPlan, nbricks: int) -> None:
    """Every brick id the sweep may read lies in ``[0, nbricks)``: the
    kernels index storage through the table unchecked."""
    t = plan.table
    top = int(t.max()) + (plan.batch - 1) * plan.batch_stride
    if t.size and (int(t.min()) < 0 or top >= int(nbricks)):
        raise ValueError(f"table ids span [{int(t.min())}, {top}] with "
                         f"batch {plan.batch}, outside {int(nbricks)} "
                         "bricks")


def sweep_fn(plan: SweepPlan, nbricks: int, kernel, name: str = "K1",
             **span_args):
    """``fn(dat_view) -> out_view`` for a plan: the plain version for a
    CPU tensor, ``kernel`` for a CUDA one.  The device table is made once
    per device.  Each call is a ``bricklib.sweep`` span (``name``: the
    kernel's; ``span_args``: more of its arguments)."""
    check_table(plan, nbricks)
    shape = (int(nbricks),) + tuple(plan.bdims)
    tables: dict = {}
    args = trace.sweep_args(name, plan.fuse, plan.ranges, **span_args)

    def fn(dat_view: torch.Tensor) -> torch.Tensor:
        if tuple(dat_view.shape) != shape:
            raise ValueError(f"storage shape {tuple(dat_view.shape)} is not "
                             f"{shape}")
        dev = dat_view.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
        with trace.span(trace.SWEEP, args):
            if dev.type == "cpu":
                return pencil_sweep_plain(dat_view, tables[dev], plan)
            return kernel(dat_view, tables[dev], plan)

    fn.plan = plan
    return fn


def pencil_stencil(stencil, grid: np.ndarray,
                   bdims: Sequence[int],
                   ghost_bricks: Sequence[int],
                   nbricks: int,
                   params: dict | None = None,
                   tile_j: int | None = None,
                   skip: int = 1,
                   **kw):
    """Classic full-domain pencil sweep: ``skip=1`` computes the owned
    rows and pencils only, ``skip=0`` the ghost ring too (port of
    ``pallas_pencil_stencil``, pencil_kernel.py:889)."""
    gzk, gzj = int(ghost_bricks[0]), int(ghost_bricks[1])
    if gzk != 1 or gzj != 1:
        raise ValueError("pencil path expects exactly one ghost brick "
                         "in k and j")
    if skip not in (0, 1):
        raise ValueError("skip is 0 (ghost-inclusive) or 1 (owned only)")
    g = np.asarray(grid)
    GK, GJ = g.shape[0], g.shape[1]
    return pencil_sweep(
        stencil, grid, bdims, nbricks, params,
        k_range=(skip, GK - skip), j_range=(skip, GJ - skip),
        tile_j=tile_j, **kw)
