"""The fused pencil sweep on PyTorch (port of
``bricklib_tpu/codegen/pencil_kernel.py``).

:func:`pencil_sweep` has the meaning of the reference's
``pallas_pencil_sweep``: storage ``[nbricks, BK, BJ, BI]`` is read through
a grid table ``T[GK, GJ]`` with one pencil brick (the whole i extent) per
(k, j) cell; the sweep computes the brick rows ``k_range`` x pencils
``j_range`` and applies ``fuse`` = F stencil iterations per pass over
device memory.  The semantics, which :func:`pencil_sweep_plain` spells out
and kernel K1 (``csrc/pencil_sweep.cu``) reproduces:

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

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches K1
or raises.  The TPU scheduling arguments (``tile_j``, ``lookahead``,
``wait_late``, ``j_shift``, ``vmem_limit_bytes``, ``interpret``) are
checked as the reference checks them and change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .evaluate import TorchNS, evaluate, resolve_const_from_params
from .ir import StencilIR
from .taps import TapTable, as_ir, params_from_reference

FEATURES_ITEM = "remaining pencil_sweep features"
KERNEL_THREADS = 256
# shared memory per block: 76 KiB lets three blocks share one SM
SMEM_BUDGET = 76 * 1024
MAX_TILE_I = 128


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

    def written_bricks(self) -> np.ndarray:
        """Storage ids this sweep writes (sorted, unique)."""
        ids = self.table[tuple(slice(a, b) for a, b in self.ranges)]
        return np.unique(np.concatenate(
            [ids.ravel() + s * self.batch_stride
             for s in range(self.batch)]))

    def tile(self) -> tuple[int, int]:
        """(i lanes per block, shared-memory bytes) for kernel K1: the
        widest power-of-two i tile dividing BI whose level-0 and level-1
        tiles and level-0 row offsets fit :data:`SMEM_BUDGET`."""
        BK, BJ, BI = self.bdims
        F = self.fuse
        rk, rj, ri = (l + h for l, h in zip(self.lo, self.hi))
        rows0 = (BK + F * rk) * (BJ + F * rj)
        ti = MAX_TILE_I
        while ti >= 1:
            if BI % ti == 0:
                s0 = rows0 * (ti + F * ri)
                s1 = ((BK + (F - 1) * rk) * (BJ + (F - 1) * rj)
                      * (ti + (F - 1) * ri)) if F > 1 else 0
                nbytes = 4 * ((s0 + s1 + 1) & ~1) + 8 * rows0
                if nbytes <= SMEM_BUDGET:
                    return ti, nbytes
            ti //= 2
        raise ValueError(f"no i tile of BI={BI} fits {SMEM_BUDGET} bytes "
                         f"of shared memory at fuse={F}")


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def _apply_level(srcs: list, plan: SweepPlan) -> torch.Tensor:
    """One stencil iteration on dense ``[batch, *outer, BI]`` levels, one
    per input field; the result is smaller by the radius on each side of
    every outer axis, periodic in i.  Taps add in tap order."""
    lo, hi = plan.lo, plan.hi
    no = len(plan.bdims) - 1
    sizes = [srcs[0].shape[1 + a] - lo[a] - hi[a] for a in range(no)]

    def shifted(f, offs):
        v = srcs[f][(slice(None),) + tuple(
            slice(lo[a] + offs[a], lo[a] + offs[a] + sizes[a])
            for a in range(no))]
        return torch.roll(v, -offs[no], dims=no + 1) if offs[no] else v

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
    *outer, BI]`` tensors over the output ranges grown by the radius.
    Level 0 clamps whole bricks at the table edge in every outer axis;
    after each intermediate level the k rows outside the table take the
    clamped row's values.  ``x`` is the storage, or for a multi-input
    stencil (``fuse=1``) one storage per name of ``plan.fields``."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if len(xs) > 1 and plan.fuse != 1:
        raise ValueError("a multi-input sweep applies one level")
    x = xs[0]
    bd = plan.bdims
    no = len(bd) - 1
    G = plan.table.shape
    F = plan.fuse
    dev = x.device
    ids = table.long()
    offs = []
    for a, (R0, R1) in enumerate(plan.ranges):
        c = torch.arange(R0 * bd[a] - F * plan.lo[a],
                         R1 * bd[a] + F * plan.hi[a], device=dev)
        b = torch.div(c, bd[a], rounding_mode="floor")
        shape = [1] * no
        shape[a] = -1
        ids = ids.index_select(a, b.clamp(0, G[a] - 1))
        offs.append((c - b * bd[a]).reshape(shape))
    strides = torch.arange(plan.batch, device=dev) * plan.batch_stride
    ids = ids[None] + strides.reshape((-1,) + (1,) * no)
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
    for c, b in zip(counts, bd[:no]):
        split += [c, b]
    perm = ([0] + [1 + 2 * a for a in range(no)]
            + [2 + 2 * a for a in range(no)] + [1 + 2 * no])
    vals = level.reshape(split + [bd[no]]).permute(perm).reshape(
        (-1,) + tuple(bd))
    wids = table[tuple(slice(R0, R1) for R0, R1 in plan.ranges)].long()
    wids = (wids[None] + strides.reshape((-1,) + (1,) * no)).reshape(-1)
    out = torch.empty_like(x)
    out[wids] = vals
    return out


def pencil_sweep_kernel(x: torch.Tensor, table: torch.Tensor,
                        plan: SweepPlan) -> torch.Tensor:
    """Launch kernel K1 on CUDA tensors; returns a fresh output whose
    unwritten bricks are undefined."""
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("kernel K1 takes storage and table on one CUDA "
                         f"device, got {x.device} and {table.device}")
    if plan.taps is None:
        raise not_ported("a nonlinear stencil on a CUDA tensor",
                         FEATURES_ITEM)
    BK, BJ, BI = plan.bdims
    GK, GJ = plan.table.shape
    if (x.dtype != torch.float32 or x.dim() != 4
            or tuple(x.shape[1:]) != (BK, BJ, BI) or not x.is_contiguous()):
        raise ValueError(f"storage must be contiguous float32 [nb, {BK}, "
                         f"{BJ}, {BI}], got {x.dtype} {tuple(x.shape)}")
    if (table.dtype != torch.int32 or tuple(table.shape) != (GK, GJ)
            or not table.is_contiguous()):
        raise ValueError("table must be contiguous int32 "
                         f"[{GK}, {GJ}]")
    if len(plan.taps.coeffs) > 128:
        raise ValueError("kernel K1 takes at most 128 taps")
    ti, smem = plan.tile()
    (K0, K1), (J0, J1) = plan.ranges
    if plan.batch * (K1 - K0) > 65535:
        raise ValueError("kernel K1 takes at most 65535 batch x k rows")
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        GK, GJ, BK, BJ, BI, K0, K1, J0, J1, plan.fuse,
        klo, khi, jlo, jhi, ilo, ihi, ti, plan.batch, plan.batch_stride,
        len(coeffs), offs.ctypes.data, coeffs.ctypes.data, smem,
        KERNEL_THREADS, _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep")
    pencil_sweep_kernel.launches += 1
    return out


pencil_sweep_kernel.launches = 0


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
    stack in one launch.  i-bricked tables, ``inplace``, multi-input
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
    if grid.ndim == 3:
        if grid.shape[2] > 1:
            raise not_ported("i-bricked tables (GI > 1)", FEATURES_ITEM)
        grid = grid[:, :, 0]
    if i_range is not None and tuple(i_range) != (0, 1):
        raise ValueError("i_range applies to i-bricked layouts only")
    lo, hi = ir.radius()
    GK, GJ = grid.shape
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
        ranges=((K0, K1), (J0, J1)), fuse=F,
        lo=tuple(int(v) for v in lo), hi=tuple(int(v) for v in hi),
        taps=(params_from_reference(params, ir) if ir.linear is not None
              else None),
        ir=ir, params=dict(params or {}), batch=batch, batch_stride=stride)
    return sweep_fn(plan, nbricks, pencil_sweep_kernel)


def check_table(plan: SweepPlan, nbricks: int) -> None:
    """Every brick id the sweep may read lies in ``[0, nbricks)``: the
    kernels index storage through the table unchecked."""
    t = plan.table
    top = int(t.max()) + (plan.batch - 1) * plan.batch_stride
    if t.size and (int(t.min()) < 0 or top >= int(nbricks)):
        raise ValueError(f"table ids span [{int(t.min())}, {top}] with "
                         f"batch {plan.batch}, outside {int(nbricks)} "
                         "bricks")


def sweep_fn(plan: SweepPlan, nbricks: int, kernel):
    """``fn(dat_view) -> out_view`` for a plan: the plain version for a
    CPU tensor, ``kernel`` for a CUDA one.  The device table is made once
    per device."""
    check_table(plan, nbricks)
    shape = (int(nbricks),) + tuple(plan.bdims)
    tables: dict = {}

    def fn(dat_view: torch.Tensor) -> torch.Tensor:
        if tuple(dat_view.shape) != shape:
            raise ValueError(f"storage shape {tuple(dat_view.shape)} is not "
                             f"{shape}")
        dev = dat_view.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
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
