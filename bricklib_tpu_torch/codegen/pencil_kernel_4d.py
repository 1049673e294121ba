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
rules out as dense tensor code, and kernel K4 (``csrc/pencil_sweep_4d.cu``)
reproduces them.  A CPU tensor takes the plain version; a CUDA tensor
launches K4 or raises.  The TPU scheduling arguments (``tile_j``,
``lookahead``, ``vmem_limit_bytes``, ``interpret``) are checked as the
reference checks them and change nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .pencil_kernel import (FEATURES_ITEM, MAX_TILE_I, SweepPlan, _is_f32,
                            sweep_fn)
from .pencil_kernel import pencil_sweep_plain as pencil_sweep_4d_plain
from .taps import as_ir, params_from_reference

__all__ = ["K4_SMEM_BUDGET", "K4_THREADS", "pencil_sweep_4d",
           "pencil_sweep_4d_kernel", "pencil_sweep_4d_plain", "tile_4d"]

# shared memory per block: 113 KiB lets two blocks share one SM
K4_SMEM_BUDGET = 113 * 1024
# threads per block: the level-0 loads wait on device memory, and 512
# threads (two blocks, 32 warps per SM) hide more of that wait than 256
# (17% faster at the 4-D step's shape) or 1024 (one block per SM)
K4_THREADS = 512
# the tiles K4 can address: float-reciprocal index math is exact below 2^20
MAX_TILE_ELEMS = 1 << 20


def _tile_cost(plan: SweepPlan, tw: int, ti: int) -> tuple[float, int, int]:
    """(work per output element, shared-memory bytes, level-0 elements) of
    a K4 block that owns ``tw`` w-slices and ``ti`` i-lanes of a brick."""
    BW, BK, BJ, _BI = plan.bdims
    F = plan.fuse
    rw, rk, rj, ri = (l + h for l, h in zip(plan.lo, plan.hi))

    def size(f):
        d = F - f
        return (tw + d * rw) * (BK + d * rk) * (BJ + d * rj) * (ti + d * ri)

    rows0 = (tw + F * rw) * (BK + F * rk) * (BJ + F * rj)
    n0, n1 = size(0), size(1) if F > 1 else 0
    nbytes = 4 * ((n0 + n1 + 1) & ~1) + 8 * rows0
    ntaps = len(plan.taps.coeffs)
    work = n0 + ntaps * sum(size(f) for f in range(1, F + 1))
    return work / (tw * BK * BJ * ti), nbytes, n0


def tile_4d(plan: SweepPlan) -> tuple[int, int, int]:
    """(w slices per block, i lanes per block, shared-memory bytes) for
    kernel K4: of the tiles whose level-0 and level-1 tiles and row
    offsets fit :data:`K4_SMEM_BUDGET`, the one of least estimated work
    per output element (level-0 loads plus tap reads over all levels).
    Raises when none fits: K4 never falls back."""
    BW, _BK, _BJ, BI = plan.bdims
    best = None
    for tw in (d for d in range(1, BW + 1) if BW % d == 0):
        ti = 1
        while ti <= min(BI, MAX_TILE_I):
            if BI % ti == 0:
                work, nbytes, n0 = _tile_cost(plan, tw, ti)
                if (nbytes <= K4_SMEM_BUDGET and n0 < MAX_TILE_ELEMS
                        and (best is None or work < best[0])):
                    best = (work, tw, ti, nbytes)
            ti *= 2
    if best is None:
        raise ValueError(f"no K4 tile of brick {plan.bdims} fits "
                         f"{K4_SMEM_BUDGET} bytes of shared memory at "
                         f"fuse={plan.fuse}")
    return best[1:]


def pencil_sweep_4d_kernel(x: torch.Tensor, table: torch.Tensor,
                           plan: SweepPlan) -> torch.Tensor:
    """Launch kernel K4 on CUDA tensors; returns a fresh output whose
    unwritten bricks are undefined."""
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
    tw, ti, smem = tile_4d(plan)
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    if plan.batch * (W1 - W0) * (K1 - K0) > 65535 or J1 - J0 > 65535:
        raise ValueError("kernel K4 takes at most 65535 batch x w x k "
                         "bricks and 65535 j pencils")
    (wlo, klo, jlo, ilo), (whi, khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep_4d(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        GW, GK, GJ, BW, BK, BJ, BI, W0, W1, K0, K1, J0, J1, plan.fuse,
        wlo, whi, klo, khi, jlo, jhi, ilo, ihi, tw, ti, plan.batch,
        plan.batch_stride, len(coeffs),
        offs.ctypes.data, coeffs.ctypes.data, smem, K4_THREADS,
        _build.stream_handle(x.device))
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
    return sweep_fn(plan, nbricks, pencil_sweep_4d_kernel)
