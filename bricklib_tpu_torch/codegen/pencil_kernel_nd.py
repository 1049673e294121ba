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
(``csrc/pencil_sweep_nd.cu``) reproduces it.  A CPU tensor takes the plain
version; a CUDA tensor launches K12 or raises.  Nothing in ``Problem`` or
the drivers calls this sweep, as in the reference: rank 5 and above runs
on the oracle there.  The TPU scheduling arguments (``tile_j``,
``lookahead``, ``vmem_limit_bytes``, ``interpret``, and the Mosaic rule on
BI and BJ that applies only on the TPU) are checked as the reference
checks them and change nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .pencil_kernel import (FEATURES_ITEM, SweepPlan, _is_f32, check_table,
                            pencil_sweep_plain)
from .taps import as_ir, params_from_reference

__all__ = ["K12_MAX_FIELDS", "K12_MAX_RANK", "K12_MAX_TAPS", "K12_THREADS",
           "k12_args", "pencil_sweep_nd", "pencil_sweep_nd_kernel"]

# the fixed caps of kernel K12's parameter block (csrc/pencil_sweep_nd.cu)
K12_MAX_RANK = 8
K12_MAX_FIELDS = 8
K12_MAX_TAPS = 512
K12_THREADS = 256


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


def pencil_sweep_nd_kernel(xs, table: torch.Tensor, taps: torch.Tensor,
                           plan: SweepPlan) -> torch.Tensor:
    """Launch kernel K12 on CUDA tensors: ``xs`` the input storages (one
    per field), ``taps`` the device copy of :func:`k12_args`' table.
    Returns a fresh output whose unwritten bricks are undefined."""
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
    if (taps.device != x.device or taps.dtype != torch.int32
            or tuple(taps.shape) != rows.shape):
        raise ValueError(f"tap table must be int32 {rows.shape} on the "
                         "storages' card")
    nd = len(plan.bdims)
    pad = [0] * (K12_MAX_RANK - nd)
    dims = np.asarray(list(plan.bdims) + pad, np.int32)
    grid = np.asarray(list(G) + pad + [0], np.int32)
    first = np.asarray([r[0] for r in plan.ranges] + pad + [0], np.int32)
    count = np.asarray([r[1] - r[0] for r in plan.ranges] + pad + [0],
                       np.int32)
    ptrs = np.asarray([xi.data_ptr() for xi in xs]
                      + [0] * (K12_MAX_FIELDS - nf), np.uint64)
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep_nd(
        ptrs.ctypes.data, nf, out.data_ptr(), table.data_ptr(), nd,
        dims.ctypes.data, grid.ctypes.data, first.ctypes.data,
        count.ctypes.data, taps.data_ptr(), len(rows), K12_THREADS,
        _build.stream_handle(x.device))
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
        if dev.type == "cpu":
            return pencil_sweep_plain(list(views), per_dev[dev], plan)
        if (dev, "taps") not in per_dev:
            per_dev[dev, "taps"] = torch.from_numpy(k12_args(plan)[0]).to(
                dev)
        return pencil_sweep_nd_kernel(list(views), per_dev[dev],
                                      per_dev[dev, "taps"], plan)

    if multi:
        fn = run
        fn.fields = fields
    else:
        def fn(dat_view):
            return run(dat_view)

    fn.plan = plan
    return fn
