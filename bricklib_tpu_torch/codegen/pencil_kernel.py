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

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches K1
or raises.  The TPU scheduling arguments (``tile_j``, ``lookahead``,
``wait_late``, ``j_shift``, ``vmem_limit_bytes``, ``interpret``) are
checked as the reference checks them and change nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from bricklib_tpu.codegen.evaluate import evaluate, resolve_const_from_params
from bricklib_tpu.codegen.ir import StencilIR

from .. import _build
from ..convert import TapTable, as_ir, params_from_reference
from ..core import not_ported

FEATURES_ITEM = "remaining pencil_sweep features"
KERNEL_THREADS = 256
# shared memory per block: 76 KiB lets three blocks share one SM
SMEM_BUDGET = 76 * 1024
MAX_TILE_I = 128


@dataclass(frozen=True)
class SweepPlan:
    """Everything static about one sweep: brick shape, table, ranges,
    fused levels, radius per side ``(k, j, i)``, and either the linear tap
    table (``taps``) or, for a nonlinear stencil, its IR and resolver."""

    bdims: tuple
    table: np.ndarray
    k_range: tuple
    j_range: tuple
    fuse: int
    lo: tuple
    hi: tuple
    taps: TapTable | None
    ir: StencilIR
    params: dict

    def written_bricks(self) -> np.ndarray:
        """Storage ids this sweep writes (sorted, unique)."""
        (K0, K1), (J0, J1) = self.k_range, self.j_range
        return np.unique(self.table[K0:K1, J0:J1])

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


class _TorchNS:
    """The array namespace the reference evaluator expects, on tensors
    (``torch.maximum`` and friends refuse Python scalars)."""

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(a):
            a, b = b, a
        return (torch.maximum(a, b) if torch.is_tensor(b)
                else torch.clamp(a, min=b))

    @staticmethod
    def minimum(a, b):
        if not torch.is_tensor(a):
            a, b = b, a
        return (torch.minimum(a, b) if torch.is_tensor(b)
                else torch.clamp(a, max=b))

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    abs = staticmethod(lambda v: torch.abs(v) if torch.is_tensor(v)
                       else abs(v))
    sqrt = staticmethod(lambda v: torch.sqrt(v) if torch.is_tensor(v)
                        else math.sqrt(v))
    exp = staticmethod(lambda v: torch.exp(v) if torch.is_tensor(v)
                       else math.exp(v))
    log = staticmethod(lambda v: torch.log(v) if torch.is_tensor(v)
                       else math.log(v))
    logical_not = staticmethod(torch.logical_not)
    logical_and = staticmethod(torch.logical_and)
    logical_or = staticmethod(torch.logical_or)


def _apply_level(src: torch.Tensor, plan: SweepPlan) -> torch.Tensor:
    """One stencil iteration on a dense ``[NK, NJ, BI]`` level; the result
    is smaller by the radius on each side of k and j, periodic in i."""
    (klo, jlo, _), (khi, jhi, _) = plan.lo, plan.hi
    nk = src.shape[0] - klo - khi
    nj = src.shape[1] - jlo - jhi

    def shifted(dk, dj, di):
        v = src[klo + dk:klo + dk + nk, jlo + dj:jlo + dj + nj]
        return torch.roll(v, -di, dims=2) if di else v

    if plan.taps is None:
        def read_tap(_name, offs_edsl):
            return shifted(*(int(offs_edsl[2 - a]) for a in range(3)))

        out = evaluate(plan.ir.sdef.rhs, read_tap,
                       resolve_const_from_params(plan.params), _TorchNS)
        return out.to(src.dtype)
    acc = None
    for (dk, dj, di), c in zip(plan.taps.offsets.tolist(),
                               plan.taps.coeffs.tolist()):
        t = c * shifted(dk, dj, di)
        acc = t if acc is None else acc + t
    return acc


def pencil_sweep_plain(x: torch.Tensor, table: torch.Tensor,
                       plan: SweepPlan) -> torch.Tensor:
    """The plain PyTorch version of kernel K1, on any device: the levels
    as dense tensors over the output range grown by the radius."""
    BK, BJ, BI = plan.bdims
    GK, GJ = plan.table.shape
    (K0, K1), (J0, J1), F = plan.k_range, plan.j_range, plan.fuse
    (klo, jlo, _), (khi, jhi, _) = plan.lo, plan.hi
    dev = x.device
    kk = torch.arange(K0 * BK - F * klo, K1 * BK + F * khi, device=dev)
    jj = torch.arange(J0 * BJ - F * jlo, J1 * BJ + F * jhi, device=dev)
    kb = torch.div(kk, BK, rounding_mode="floor")
    jb = torch.div(jj, BJ, rounding_mode="floor")
    ids = table.long()[kb.clamp(0, GK - 1)[:, None],
                       jb.clamp(0, GJ - 1)[None, :]]
    level = x[ids, (kk - kb * BK)[:, None], (jj - jb * BJ)[None, :]]
    for f in range(1, F + 1):
        level = _apply_level(level, plan)
        kbase = K0 * BK - (F - f) * klo
        if f < F and (kbase < 0 or kbase + level.shape[0] > GK * BK):
            rows = torch.arange(kbase, kbase + level.shape[0], device=dev)
            rb = torch.div(rows, BK, rounding_mode="floor")
            level = level[rb.clamp(0, GK - 1) * BK + rows - rb * BK - kbase]
    KC, JC = K1 - K0, J1 - J0
    out = torch.empty_like(x)
    out[table[K0:K1, J0:J1].reshape(-1).long()] = (
        level.reshape(KC, BK, JC, BJ, BI).permute(0, 2, 1, 3, 4)
        .reshape(KC * JC, BK, BJ, BI))
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
    (K0, K1), (J0, J1) = plan.k_range, plan.j_range
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep(
        x.data_ptr(), out.data_ptr(), table.data_ptr(),
        GK, GJ, BK, BJ, BI, K0, K1, J0, J1, plan.fuse,
        klo, khi, jlo, jhi, ilo, ihi, ti, len(coeffs),
        offs.ctypes.data, coeffs.ctypes.data, smem, KERNEL_THREADS,
        _build.stream_handle(x.device))
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
    (``bricklib_tpu/codegen/pencil_kernel.py:296``).  i-bricked tables,
    ``batch > 1``, ``inplace``, multi-input stencils and systems, and bf16
    storage raise ``NotImplementedError``; a nonlinear stencil runs on
    CPU tensors only."""
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
    if int(batch) > 1:
        if batch_stride is None:
            raise ValueError("batch > 1 needs batch_stride (bricks per "
                             "subdomain)")
        raise not_ported("batched sweeps (batch > 1)", FEATURES_ITEM)
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
        k_range=(K0, K1), j_range=(J0, J1), fuse=F,
        lo=tuple(int(v) for v in lo), hi=tuple(int(v) for v in hi),
        taps=(params_from_reference(params, ir) if ir.linear is not None
              else None),
        ir=ir, params=dict(params or {}))
    tables: dict = {}

    def fn(dat_view: torch.Tensor) -> torch.Tensor:
        if tuple(dat_view.shape) != (int(nbricks), BK, BJ, BI):
            raise ValueError(f"storage shape {tuple(dat_view.shape)} is not "
                             f"({int(nbricks)}, {BK}, {BJ}, {BI})")
        dev = dat_view.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
        if dev.type == "cpu":
            return pencil_sweep_plain(dat_view, tables[dev], plan)
        return pencil_sweep_kernel(dat_view, tables[dev], plan)

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
