"""The rank-5+ pencil sweep on PyTorch (port of
``bricklib_tpu/codegen/pencil_kernel_nd.py``).

:func:`pencil_sweep_nd` has the meaning of the reference's
``pallas_pencil_sweep_nd``: a rank-``nd`` (``nd >= 5``) stencil at
``fuse=1`` on storage ``[nbricks, B_0, ..., B_{m-1}, BK, BJ, BI]`` (``m =
nd - 3`` outer axes), read through a grid table ``T[G_0, ..., G_{m-1}, GK,
GJ]`` with one pencil brick (the whole i row) per cell.  It computes the
bricks of ``ranges`` (one half-open range per table axis; by default one
ghost ring skipped on every axis).  Each output element is the stencil
over its neighbourhood:

- i wraps inside the brick row (modulo BI);
- on every other axis the halo comes from the +-1 neighbour brick, corner
  combinations included, and brick coordinates clamp to the table edge on
  each axis separately (the reference's ``_clip``);
- several input fields are read through the same table.

:func:`~.pencil_kernel.pencil_sweep_plain`, the plain version of every
pencil sweep, spells this out in tensor code; kernel K12
(``csrc/pencil_sweep_nd.cu``, ``csrc/pencil_stream_nd.cuh``) reproduces
it, streaming k through each block: :func:`stream_plan_nd` plans the
launch (one outer brick cell, a chunk of brick rows, pencils and an i tile
a block) and :func:`nd_info` lays out its slices (the outer positions the
taps reach, each in ring A or B of shared memory) and tap offsets.  A CPU
tensor takes the plain version; a CUDA tensor launches K12 or raises.
Nothing in ``Problem`` or the drivers calls this sweep, as in the
reference: rank 5 and above runs
on the oracle there.  The TPU scheduling arguments (``tile_j``,
``lookahead``, ``vmem_limit_bytes``, ``interpret``, and the Mosaic rule on
BI and BJ that applies only on the TPU) are checked as the reference
checks them and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from itertools import product
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..core import not_ported
from .pencil_kernel import (BLOCK_COST, FEATURES_ITEM, LOAD_COST,
                            PLANE_SPAN, SM_BLOCK_RESERVE, SM_COUNT, SM_SMEM,
                            SM_THREADS, STEP_COST, STREAM_ROWS,
                            STREAM_SMEM_BUDGET, STREAM_THREADS, SweepPlan,
                            _is_f32, check_table, pencil_sweep_plain)
from .taps import as_ir, params_from_reference

__all__ = ["K12_HEADER", "K12_MAX_FIELDS", "K12_MAX_RANK", "K12_MAX_TAPS",
           "K12_SMEM_BUDGET", "K12_STAR11", "K12_THREADS", "NdSlices",
           "StreamNdPlan", "k12_args", "nd_info", "nd_slices",
           "pencil_sweep_nd", "pencil_sweep_nd_kernel", "stream_nd_footprint",
           "stream_nd_smem", "stream_plan_nd"]

# the fixed caps of kernel K12's parameter block (csrc/pencil_stream_nd.cuh)
K12_MAX_RANK = 8
K12_MAX_FIELDS = 8
K12_MAX_TAPS = 512
# K12's k-streaming blocks: threads, the shared memory one block may take,
# the most pencils a block owns
K12_THREADS = STREAM_THREADS
K12_SMEM_BUDGET = STREAM_SMEM_BUDGET
K12_MAX_PENCILS = 8
# the tap layout K12 compiles in (csrc/tap_layouts.cuh, LayoutStar11): the
# 5-D 11-point star of one input, offsets in numpy axis order, tap order
K12_STAR11 = ((0, 0, 0, 0, 0), (0, 0, 0, 0, 1), (0, 0, 0, 0, -1),
              (0, 0, 0, 1, 0), (0, 0, 0, -1, 0), (0, 0, 1, 0, 0),
              (0, 0, -1, 0, 0), (0, 1, 0, 0, 0), (0, -1, 0, 0, 0),
              (1, 0, 0, 0, 0), (-1, 0, 0, 0, 0))
# the launch header after (nd, bdims, grid, first, count), in the order
# bt_pencil_sweep_nd reads it
K12_HEADER = ("kch", "pj", "ti", "h", "pw", "d", "PB", "NS", "NRA", "NRB",
              "PSA", "PSB", "nitems", "o_slice", "o_rows", "o_pofs",
              "o_toff", "o_tring", "o_taps", "klo", "khi", "jlo", "layout")


def k12_args(plan: SweepPlan) -> tuple[np.ndarray, int]:
    """The tap table kernel K12 reads, int32 ``[ntaps, nd + 2]`` rows of
    (input field, coefficient bits, offset per axis in numpy order), and
    the number of input fields; raises where the plan exceeds the
    kernel's caps (rank, fields, taps) or is nonlinear."""
    nd = len(plan.bdims)
    if nd > K12_MAX_RANK:
        raise ValueError(f"kernel K12 takes ranks up to K12_MAX_RANK = "
                         f"{K12_MAX_RANK}, got {nd}")
    nf = max(len(plan.fields), 1)
    if nf > K12_MAX_FIELDS:
        raise ValueError(f"kernel K12 takes at most {K12_MAX_FIELDS} input "
                         f"fields, got {nf}")
    if plan.taps is None:
        raise not_ported("a nonlinear stencil on a CUDA tensor",
                         FEATURES_ITEM)
    n = len(plan.taps.coeffs)
    if n > K12_MAX_TAPS:
        raise ValueError(f"kernel K12 takes at most {K12_MAX_TAPS} taps, "
                         f"got {n}")
    rows = np.zeros((n, nd + 2), np.int32)
    if plan.taps.inputs is not None:
        rows[:, 0] = plan.taps.inputs
    rows[:, 1] = np.ascontiguousarray(plan.taps.coeffs,
                                      np.float32).view(np.int32)
    rows[:, 2:] = plan.taps.offsets
    return rows, nf


@dataclass(frozen=True)
class NdSlices:
    """What the outputs of one outer brick cell read, footprint aside.
    ``positions``: the cell's outer positions (in-brick coordinates, row
    major); ``slices``: per distinct (input field, outer position relative
    to the cell's first) that a tap of some position reaches, ``(field,
    position, j reach below, j reach above, ring)``, ring 0 (A: some tap
    reads it at a k offset other than 0) first; ``slice_of[p][t]``: the
    slice tap ``t`` of position ``p`` reads."""

    positions: tuple
    slices: tuple
    slice_of: tuple

    def ring_rows(self, ring: int, wjm: int) -> int:
        """Level-0 rows of one plane of ``ring`` for ``wjm`` output j
        rows."""
        return sum(wjm + lo + hi for _f, _p, lo, hi, r in self.slices
                   if r == ring)


# what the host works out once per plan (and footprint): a launch only
# looks it up
_memo: dict = {}


def _memo_of(plan: SweepPlan, what, fn):
    """``fn()``, made once per (plan's shapes and taps, ``what``)."""
    t = plan.taps
    key = (tuple(plan.bdims), plan.table.shape, tuple(plan.ranges),
           tuple(plan.lo), tuple(plan.hi), plan.fields, t.offsets.tobytes(),
           None if t.inputs is None else np.asarray(t.inputs).tobytes(),
           np.asarray(t.coeffs, np.float32).tobytes(), what)
    if key not in _memo:
        _memo[key] = fn()
    return _memo[key]


def nd_slices(plan: SweepPlan) -> NdSlices:
    """The :class:`NdSlices` of a rank-5+ sweep's taps."""
    return _memo_of(plan, "slices", lambda: _nd_slices(plan))


def _nd_slices(plan: SweepPlan) -> NdSlices:
    m = len(plan.bdims) - 3
    offs = [tuple(int(v) for v in o) for o in plan.taps.offsets.tolist()]
    fields = (plan.taps.inputs.tolist() if plan.taps.inputs is not None
              else [0] * len(offs))
    positions = tuple(product(*(range(b) for b in plan.bdims[:m])))
    reach: dict = {}
    for x in positions:
        for o, f in zip(offs, fields):
            key = (int(f), tuple(x[a] + o[a] for a in range(m)))
            lo, hi, kr = reach.get(key, (0, 0, False))
            reach[key] = (max(lo, -o[m + 1]), max(hi, o[m + 1]),
                          kr or o[m] != 0)
    keys = sorted(reach, key=lambda k: (not reach[k][2], k))
    index = {k: i for i, k in enumerate(keys)}
    slices = tuple((f, pos, reach[(f, pos)][0], reach[(f, pos)][1],
                    0 if reach[(f, pos)][2] else 1) for f, pos in keys)
    slice_of = tuple(
        tuple(index[(int(f), tuple(x[a] + o[a] for a in range(m)))]
              for o, f in zip(offs, fields)) for x in positions)
    return NdSlices(positions, slices, slice_of)


@dataclass(frozen=True)
class StreamNdPlan:
    """K12's launch as :func:`stream_plan_nd` plans it: a block owns one
    outer brick cell of the ranges (the cells vary fastest between
    blocks), ``kch`` output brick rows, ``pj`` pencils and ``ti`` i lanes;
    level 0 is loaded with an i margin of ``h`` lanes in pieces of ``pw``
    floats, ``d`` planes ahead.  ``layout``: the launch runs the 5-D
    star's compiled body.  ``smem_bytes`` is its dynamic shared memory."""

    ranges: tuple
    bdims: tuple
    kch: int
    pj: int
    ti: int
    h: int
    pw: int
    d: int
    layout: bool
    smem_bytes: int

    @property
    def ncell(self) -> int:
        m = len(self.bdims) - 3
        return int(np.prod([b - a for a, b in self.ranges[:m]]))

    @property
    def nchunk(self) -> int:
        a, b = self.ranges[-2]
        return -(-(b - a) // self.kch)

    @property
    def njg(self) -> int:
        a, b = self.ranges[-1]
        return -(-(b - a) // self.pj)

    @property
    def nit(self) -> int:
        return self.bdims[-1] // self.ti

    @property
    def nstream(self) -> int:
        return self.ncell * self.nchunk * self.njg * self.nit

    def blocks(self) -> list:
        """Every block in grid order, decoded as the kernel decodes it:
        ``(outer brick cell, (k0, k1), (j0, j1), (i0, i1))`` in brick
        coordinates, brick rows, pencils and i lanes."""
        m = len(self.bdims) - 3
        cells = list(product(*(range(a, b) for a, b in self.ranges[:m])))
        (K0, K1), (J0, J1) = self.ranges[-2:]
        out = []
        for b in range(self.nstream):
            cell, b = b % self.ncell, b // self.ncell
            it, b = b % self.nit, b // self.nit
            jg, ch = b % self.njg, b // self.njg
            k0, j0 = K0 + ch * self.kch, J0 + jg * self.pj
            out.append((cells[cell], (k0, min(k0 + self.kch, K1)),
                        (j0, min(j0 + self.pj, J1)),
                        (it * self.ti, (it + 1) * self.ti)))
        return out


def _items(npos: int, pj: int, bj: int, ti: int) -> int:
    """Output items (position, quad of rows, 32 lanes) of a full block."""
    return npos * -(-pj * bj // STREAM_ROWS) * -(-ti // 32)


def stream_nd_smem(sl: NdSlices, bdims, lo, hi, kch: int, pj: int, ti: int,
                   h: int, d: int, ntaps: int) -> int:
    """Dynamic shared memory of one K12 block, laid out as
    ``pencil_stream_nd.cuh`` lays it out: ``h`` floats, ring A (``klo +
    khi + 1 + d`` planes) and ring B (``1 + d``), every plane its slices'
    rows of ``ti + 2h`` floats, the slack, rounded up to even; then the
    brick table, the output bricks and row offsets, two ints per level-0
    row, one int per (position, tap), two per tap, the positions' offsets
    and the items."""
    m = len(bdims) - 3
    BJ = bdims[m + 1]
    rw, wjm = ti + 2 * h, pj * BJ
    ra, rb = lo[m] + hi[m] + 1 + d, 1 + d
    nra, nrb = sl.ring_rows(0, wjm), sl.ring_rows(1, wjm)
    npos, ns = len(sl.positions), len(sl.slices)
    n = (h + ra * nra * rw + rb * nrb * rw + h + 40 + STREAM_ROWS * rw
         + 1) & ~1
    return (4 * n + 8 * (kch + 2) * ns * (pj + 2) + 8 * kch * pj + 16 * wjm
            + 8 * (nra + nrb) + 4 * npos * ntaps + 8 * ntaps + 4 * npos
            + 4 * _items(npos, pj, BJ, ti))


def _star11(plan: SweepPlan) -> bool:
    """The launch runs the compiled 5-D star: its taps are
    :data:`K12_STAR11` on one input."""
    return (len(plan.bdims) == 5 and not plan.fields and tuple(
        map(tuple, plan.taps.offsets.tolist())) == K12_STAR11)


@lru_cache(maxsize=64)
def _stream_plan_nd(bdims, ranges, lo, hi, sl: NdSlices, ntaps: int,
                    layout: bool, budget: int) -> StreamNdPlan:
    m = len(bdims) - 3
    BK, BJ, BI = bdims[m:]
    (K0, K1), (J0, J1) = ranges[-2:]
    nrows, npen = K1 - K0, J1 - J0
    rk = lo[m] + hi[m]
    pw = 4 if BI % 4 == 0 else 1
    h = -(-max(lo[-1], hi[-1]) // pw) * pw
    npos = len(sl.positions)
    ncell = int(np.prod([b - a for a, b in ranges[:m]]))
    chunks = sorted(c for c in {-(-nrows // n) for n in range(1, nrows + 1)}
                    if (c + 2) * BK + rk + 1 < PLANE_SPAN)
    # shared-memory accesses per output: its loads (under the compiled
    # star 38 per 4 outputs; otherwise one per tap), one store, a tap's
    # address per quad
    loads = 38 / STREAM_ROWS if layout else ntaps
    per_elem = loads + 1 + ntaps / STREAM_ROWS
    nwarp = K12_THREADS // 32
    best = None
    for ti in (t for t in range(pw, BI + 1, pw) if BI % t == 0):
        rw = ti + 2 * h
        for pj in range(1, min(npen, K12_MAX_PENCILS) + 1):
            wjm = pj * BJ
            if wjm >= 4096 or ti >= 4096:
                continue
            nra, nrb = sl.ring_rows(0, wjm), sl.ring_rows(1, wjm)
            for kch in chunks:
                L = kch * BK
                # level-0 floats, and the items' outputs: a step takes as
                # long as its busiest warp's items (4 rows of 32 lanes)
                busiest = -(-_items(npos, pj, BJ, ti) // nwarp)
                work = (LOAD_COST * rw * (nra * (L + rk) + nrb * L)
                        + busiest * nwarp * STREAM_ROWS * 32 * L * per_elem)
                nblocks = ncell * -(-nrows // kch) * -(-npen // pj) * (
                    BI // ti)
                if nblocks > 2 ** 31 - 1:
                    continue
                for d in (2, 1):
                    smem = stream_nd_smem(sl, bdims, lo, hi, kch, pj, ti, h,
                                          d, ntaps)
                    if smem > budget:
                        continue
                    bps = min(SM_SMEM // (smem + SM_BLOCK_RESERVE),
                              SM_THREADS // K12_THREADS)
                    waves = -(-nblocks // (SM_COUNT * bps))
                    stall = (L + rk) * STEP_COST + BLOCK_COST
                    cost = (waves * (bps * work + stall), -d, -ti, kch)
                    if best is None or cost < best[0]:
                        best = (cost, (kch, pj, ti, d, smem))
    if best is None:
        raise ValueError(f"no K12 k-streaming block of bricks {bdims} fits "
                         f"{budget} bytes of shared memory")
    kch, pj, ti, d, smem = best[1]
    return StreamNdPlan(ranges, bdims, kch, pj, ti, h, pw, d, layout, smem)


def stream_plan_nd(plan: SweepPlan) -> StreamNdPlan:
    """Kernel K12's launch: the block footprint (k chunk, pencils, i tile,
    lookahead) of least estimated cost (K1's cost model: level-0 loads and
    shared-memory accesses per wave of blocks over the card's SMs, a
    step's fixed work) whose shared memory fits :data:`K12_SMEM_BUDGET`.
    Raises when none fits."""
    sl = nd_slices(plan)
    return _stream_plan_nd(tuple(plan.bdims), tuple(plan.ranges),
                           tuple(plan.lo), tuple(plan.hi), sl,
                           len(plan.taps.coeffs), _star11(plan),
                           K12_SMEM_BUDGET)


def stream_nd_footprint(plan: SweepPlan, kch: int, pj: int, ti: int,
                        d: int) -> StreamNdPlan:
    """The launch of ``plan`` at another footprint, its shared memory
    counted from that footprint; for measuring the planner's choice
    against its neighbours."""
    sp = stream_plan_nd(plan)
    sl = nd_slices(plan)
    return StreamNdPlan(sp.ranges, sp.bdims, kch, pj, ti, sp.h, sp.pw, d,
                        sp.layout,
                        stream_nd_smem(sl, plan.bdims, plan.lo, plan.hi, kch,
                                       pj, ti, sp.h, d,
                                       len(plan.taps.coeffs)))


def nd_info(plan: SweepPlan, sp: StreamNdPlan) -> tuple[np.ndarray, dict]:
    """The tables K12 reads from device memory (int32) at the footprint
    ``sp``, and the header values (:data:`K12_HEADER`): per slice its
    field, in-brick outer offset and cell step per outer axis; per level-0
    row of ring A then B its slice and j offset from the block's first
    output row; per position its in-brick outer offset; per (position,
    tap) the tap's offset in floats from its ring's plane and its ring;
    per tap its k offset and coefficient bits."""
    sl = nd_slices(plan)
    bd = plan.bdims
    m = len(bd) - 3
    estride = [int(np.prod(bd[a + 1:])) for a in range(len(bd))]
    BJ = bd[m + 1]
    rw, wjm = sp.ti + 2 * sp.h, sp.pj * BJ
    slice_rows, rows, base = [], [[], []], {}
    for s, (f, pos, lo, hi, ring) in enumerate(sl.slices):
        cstep = [p // b for p, b in zip(pos, bd[:m])]
        sofs = sum((p - c * b) * e for p, c, b, e in
                   zip(pos, cstep, bd[:m], estride))
        slice_rows.append([f, sofs] + cstep)
        base[s] = len(rows[ring]) * rw
        rows[ring] += [(s, j) for j in range(-lo, wjm + hi)]
    offs = plan.taps.offsets.tolist()
    toff = [base[s] + (sl.slices[s][2] + o[m + 1]) * rw + o[m + 2]
            for p, row in enumerate(sl.slice_of)
            for s, o in zip(row, offs)]
    tring = [sl.slices[s][4] for row in sl.slice_of for s in row]
    pofs = [sum(x * e for x, e in zip(pos, estride)) for pos in sl.positions]
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32).view(
        np.int32)
    taps = [[o[m], int(c)] for o, c in zip(offs, coeffs)]
    parts = [np.asarray(slice_rows, np.int64).ravel(),
             np.asarray(rows[0] + rows[1], np.int64).ravel(),
             np.asarray(pofs, np.int64), np.asarray(toff, np.int64),
             np.asarray(tring, np.int64), np.asarray(taps, np.int64).ravel()]
    at = np.cumsum([0] + [len(x) for x in parts])
    info = np.concatenate(parts).astype(np.int32)
    npos = len(sl.positions)
    hdr = {"kch": sp.kch, "pj": sp.pj, "ti": sp.ti, "h": sp.h, "pw": sp.pw,
           "d": sp.d, "PB": npos, "NS": len(sl.slices),
           "NRA": len(rows[0]), "NRB": len(rows[1]),
           "PSA": len(rows[0]) * rw, "PSB": len(rows[1]) * rw,
           "nitems": _items(npos, sp.pj, BJ, sp.ti),
           "o_slice": int(at[0]), "o_rows": int(at[1]),
           "o_pofs": int(at[2]), "o_toff": int(at[3]),
           "o_tring": int(at[4]), "o_taps": int(at[5]),
           "klo": plan.lo[m], "khi": plan.hi[m], "jlo": plan.lo[m + 1],
           "layout": int(sp.layout)}
    return info, hdr


def _launch_header(plan: SweepPlan, sp: StreamNdPlan):
    """(:func:`nd_info`'s tables, the int32 header bt_pencil_sweep_nd
    reads: nd, bdims, grid, first and count, each padded, then
    :data:`K12_HEADER`)."""
    info, hdr = nd_info(plan, sp)
    nd = len(plan.bdims)
    pad = [0] * (K12_MAX_RANK - nd)
    head = ([nd] + list(plan.bdims) + pad + list(plan.table.shape) + pad
            + [0] + [r[0] for r in plan.ranges] + pad + [0]
            + [r[1] - r[0] for r in plan.ranges] + pad + [0]
            + [hdr[k] for k in K12_HEADER])
    return info, np.asarray(head, np.int32)


def pencil_sweep_nd_kernel(xs, table: torch.Tensor, info: torch.Tensor,
                           plan: SweepPlan,
                           sp: StreamNdPlan | None = None) -> torch.Tensor:
    """Launch kernel K12 on CUDA tensors: ``xs`` the input storages (one
    per field), ``info`` the device copy of :func:`nd_info`'s tables at
    the footprint ``sp`` (``None``: the planner's).  Returns a fresh
    output whose unwritten bricks are undefined."""
    rows, nf = k12_args(plan)
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"kernel K12 runs on CUDA tensors, got {x.device}")
    shape = tuple(x.shape)
    for xi in xs:
        if (xi.device != x.device or xi.dtype != torch.float32
                or tuple(xi.shape) != shape or not xi.is_contiguous()
                or shape[1:] != tuple(plan.bdims)):
            raise ValueError(f"storages must be contiguous float32 [nb, "
                             f"*{plan.bdims}] on one card, got {xi.dtype} "
                             f"{tuple(xi.shape)} on {xi.device}")
    if len(xs) != nf:
        raise ValueError(f"the stencil reads {nf} fields, got {len(xs)}")
    G = plan.table.shape
    if (table.device != x.device or table.dtype != torch.int32
            or tuple(table.shape) != G or not table.is_contiguous()):
        raise ValueError(f"table must be contiguous int32 {G} on the "
                         "storages' card")
    sp = stream_plan_nd(plan) if sp is None else sp
    want, head = _memo_of(plan, sp, lambda: _launch_header(plan, sp))
    if (info.device != x.device or info.dtype != torch.int32
            or tuple(info.shape) != want.shape):
        raise ValueError(f"K12's tables must be int32 {want.shape} on the "
                         "storages' card")
    head = head.copy()
    ptrs = np.asarray([xi.data_ptr() for xi in xs]
                      + [0] * (K12_MAX_FIELDS - nf), np.uint64)
    # 16-byte pieces need 16-byte aligned storages
    if any(xi.data_ptr() % 16 for xi in xs) and sp.pw == 4:
        head[1 + 4 * K12_MAX_RANK + K12_HEADER.index("pw")] = 1
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep_nd(
        ptrs.ctypes.data, nf, out.data_ptr(), table.data_ptr(),
        info.data_ptr(), head.ctypes.data, len(head),
        np.ascontiguousarray(rows).ctypes.data, len(rows), sp.smem_bytes,
        K12_THREADS, _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_nd")
    pencil_sweep_nd_kernel.launches += 1
    return out


pencil_sweep_nd_kernel.launches = 0


def pencil_sweep_nd(stencil, grid: np.ndarray,
                    bdims: Sequence[int],
                    nbricks: int,
                    params: dict | None = None,
                    ranges: Sequence[tuple[int, int]] | None = None,
                    tile_j: int | None = None,
                    dtype=torch.float32,
                    compute_dtype=torch.float32,
                    interpret: bool | None = None,
                    fuse: int = 1,
                    lookahead: int = 1,
                    vmem_limit_bytes: int = 110 * 2 ** 20):
    """Build a rank-``nd`` pencil sweep (``nd >= 5``) over the table
    bricks ``ranges`` (half-open, one per table axis: outer axes, k, j;
    default: skip one ghost ring per axis); returns ``fn(dat_view) ->
    out_view`` on ``[nbricks, *bdims]`` storage, or for a multi-input
    stencil ``fn(*views)`` in ``fn.fields`` order.  ``grid`` is ``(G_0,
    ..., G_{m-1}, GK, GJ)`` or the same with a trailing 1.

    Arguments and errors follow ``pallas_pencil_sweep_nd``
    (``bricklib_tpu/codegen/pencil_kernel_nd.py:51``).  Storage or
    compute types other than float32 raise ``NotImplementedError``; a
    nonlinear stencil runs on CPU tensors only."""
    ir = as_ir(stencil)
    nd = ir.dims
    if nd < 5:
        raise NotImplementedError(
            "this path is rank-5+; use pencil_kernel{,_2d,_4d} for "
            "ranks 3/2/4")
    m = nd - 3
    fieldnames = list(ir.sdef.inputs)
    if not fieldnames:
        raise ValueError("stencil reads no input grid")
    bdims = tuple(int(b) for b in bdims)
    if len(bdims) != nd:
        raise ValueError(f"bdims must have {nd} entries, got {bdims}")
    grid = np.asarray(grid)
    if grid.ndim == nd:
        if grid.shape[-1] != 1:
            raise ValueError("pencil layout needs one brick per "
                             "(outer..., k, j)")
        grid = grid[..., 0]
    if grid.ndim != nd - 1:
        raise ValueError(f"grid table must be rank {nd - 1} "
                         f"(outer axes..., k, j), got {grid.shape}")
    if ranges is None:
        ranges = tuple((1, g - 1) for g in grid.shape)
    ranges = tuple((int(a), int(b)) for a, b in ranges)
    if len(ranges) != nd - 1:
        raise ValueError(f"need {nd - 1} ranges (outer..., k, j)")
    lo, hi = ir.radius()
    for a in range(m + 2):
        if lo[a] > bdims[a] or hi[a] > bdims[a]:
            raise ValueError("stencil radius exceeds brick dims")
    if int(fuse) != 1:
        raise NotImplementedError(
            "rank-5+ sweeps are fuse=1: every outer grid axis would "
            "recompute (F-f)*2*radius extra slices per level (the 4-D "
            "w-amplification compounded per axis; 4-D measured F=4 "
            "unpayable, tools/bench_4d.py) — use deep-ghost ST_ITER "
            "amortization instead")
    if int(lookahead) < 1:
        raise ValueError("lookahead must be >= 1")
    JC = ranges[m + 1][1] - ranges[m + 1][0]
    if tile_j is not None and JC % int(tile_j):
        raise ValueError(f"tile_j {int(tile_j)} must divide computed j "
                         f"extent {JC}")
    for a, ((R0, R1), n) in enumerate(zip(ranges, grid.shape)):
        if not 0 <= R0 < R1 <= n:
            raise ValueError(f"range {(R0, R1)} of table axis {a} outside "
                             f"its extent {n}")
    if not (_is_f32(dtype) and _is_f32(compute_dtype)):
        raise not_ported("storage or compute types other than float32",
                         FEATURES_ITEM)
    multi = len(fieldnames) > 1
    fields = tuple(fieldnames) if multi else ()
    plan = SweepPlan(
        bdims=bdims, table=np.ascontiguousarray(grid, np.int32),
        ranges=ranges, fuse=1,
        lo=tuple(int(v) for v in lo), hi=tuple(int(v) for v in hi),
        taps=(params_from_reference(params, ir, fields if multi else None)
              if ir.linear is not None else None),
        ir=ir, params=dict(params or {}), fields=fields)
    check_table(plan, nbricks)
    shape = (int(nbricks),) + bdims
    per_dev: dict = {}
    args = trace.sweep_args("K12", 1, plan.ranges)

    def run(*views):
        if len(views) != len(fieldnames):
            raise TypeError(f"stencil reads {len(fieldnames)} grids "
                            f"({fieldnames}), got {len(views)}")
        for v in views:
            if tuple(v.shape) != shape:
                raise ValueError(f"storage shape {tuple(v.shape)} is not "
                                 f"{shape}")
        dev = views[0].device
        if dev not in per_dev:
            per_dev[dev] = torch.from_numpy(plan.table).to(dev)
        if dev.type != "cpu" and (dev, "info") not in per_dev:
            k12_args(plan)
            per_dev[dev, "info"] = torch.from_numpy(
                nd_info(plan, stream_plan_nd(plan))[0]).to(dev)
        with trace.span(trace.SWEEP, args):
            if dev.type == "cpu":
                return pencil_sweep_plain(list(views), per_dev[dev], plan)
            return pencil_sweep_nd_kernel(list(views), per_dev[dev],
                                          per_dev[dev, "info"], plan)

    if multi:
        fn = run
        fn.fields = fields
    else:
        def fn(dat_view):
            return run(dat_view)

    fn.plan = plan
    return fn
