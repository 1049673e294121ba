"""The dense padded-array stencil on PyTorch (port of the dense half of
``bricklib_tpu/codegen/pallas_backend.py``).

:func:`dense_stencil` has the meaning of the reference's
``pallas_dense_stencil`` (the array twin of the brick sweep): over 3-D
arrays of the padded ``shape``, the output rows ``k`` in ``[pad[0],
shape[0] - pad[0])`` and ``j`` in ``[pad[1], shape[1] - pad[1])`` are
computed over the whole padded i width, each i tap read circularly over
the padded row (``torch.roll`` at full width, as the TPU kernel's
``jnp.roll``); the k and j pad rows of the output are zero.  Multi-input
stencils take one padded array per field, ``fn(*arrs)`` in ``fn.fields``
order.

A CPU tensor takes :func:`dense_stencil_plain` (any stencil, through the
copied executor ``jnp_backend._run``); a CUDA tensor launches kernel K7
(``csrc/dense_stencil.cu``) for a linear stencil, folded into one tap per
(field, dk, dj, di), or raises.  K7 streams k through each block: its
launch is planned by :meth:`DensePlan.stream` (k chunk, j rows and i
lanes a block, planes loaded ahead), and the 7-point star in its folded
order (s7pt, mpi7pt) runs a body with the taps' offsets compiled in.  The
reference's TPU alignment rules (padded i extent a multiple of 128, tiles
dividing the interior, j tile and j pad in whole 8-row sublanes) are kept
as checks, so both packages accept and refuse the same calls;
``tile_elems`` and ``vmem_limit_bytes`` change nothing here.
``pallas_brick_stencil`` (the i-bricked wrapper of kernel 1) is not
ported: :func:`brick_stencil` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..core import not_ported
from .evaluate import TorchNS, resolve_const_from_params
from .jnp_backend import _np_offsets, _run
from .pencil_kernel import (BLOCK_COST, FEATURES_ITEM, LOAD_COST, SM_COUNT,
                            SM_SMEM, SM_BLOCK_RESERVE, SM_THREADS, STEP_COST,
                            STREAM_ROWS, STREAM_SMEM_BUDGET, STREAM_THREADS,
                            _is_f32, _layouts, stream_loads)
from .pencil_kernel_2d import fold_linear_forms
from .taps import as_ir

__all__ = ["K7_LAYOUTS", "K7_MAX_FIELDS", "K7_MAX_TAPS", "DensePlan",
           "DenseStream", "brick_stencil", "choose_tile", "dense_smem",
           "dense_stencil", "dense_stencil_kernel", "dense_stencil_plain",
           "launch_dense"]

K7_MAX_FIELDS = 8
K7_MAX_TAPS = 128
# output j rows a block may own (multiples of STREAM_ROWS)
K7_MAX_TJ = 64
# output k rows a chunk may hold: on the H100 the first out-of-core slab
# ran 0.56 to 0.57 ms in chunks of 8 to 21 rows against 0.63 in one chunk
# of 147, at the same j rows and i lanes (bench/k7_regimes.py --footprints)
K7_MAX_KCH = 24
# the tap layouts K7 compiles in (csrc/tap_layouts.cuh, in the folded order
# of plan.taps): the 7-point star (s7pt; mpi7pt has its offsets)
K7_LAYOUTS = ("s7pt",)


def choose_tile(interior_cells: Sequence[int], bdims: Sequence[int],
                target_elems: int = 32) -> tuple[int, ...]:
    """Pick a cell-tile size per given axis (callers pass the axes they
    tile — the innermost is always covered whole and excluded).  Prefers
    ~``target_elems`` elements per axis, must divide the interior
    cell count.

    Original: ``bricklib_tpu/codegen/pallas_backend.py:choose_tile``."""
    out = []
    for cells, b in zip(interior_cells, bdims):
        want = max(1, target_elems // b)
        t = 1
        for cand in range(1, cells + 1):
            if cells % cand == 0 and cand <= want:
                t = cand
        out.append(t)
    return tuple(out)


def brick_stencil(*args, **kw):
    """``pallas_brick_stencil``: the i-bricked mode of the pencil sweep,
    which the port does not have yet."""
    raise not_ported("pallas_brick_stencil (i-bricked pencil sweeps)",
                     FEATURES_ITEM)


@dataclass(frozen=True)
class DensePlan:
    """Everything static about one dense stencil: the padded ``shape``,
    the pads, the reach of the taps per side (numpy axis order), the input
    fields in ``fn.fields`` order, the IR and params, and for a linear
    stencil its folded taps ``((field, dk, dj, di), coefficient)`` (None
    otherwise)."""

    shape: tuple
    pad: tuple
    lo: tuple
    hi: tuple
    fields: tuple
    ir: object
    params: dict
    taps: tuple | None

    def interior(self) -> tuple:
        return tuple(s - 2 * p for s, p in zip(self.shape, self.pad))

    def layout(self) -> str | None:
        """The tap layout K7 compiles in that this stencil's folded taps
        equal, offsets and order (one field, reach equal on every side of
        k and j): the corpus stencil it is named after, or None for the
        generic body."""
        if self.taps is None or len(self.fields) != 1:
            return None
        offs = [list(k[1:]) for k, _c in self.taps]
        for name, lay in zip(K7_LAYOUTS, _layouts(K7_LAYOUTS)):
            r = max(max(abs(v) for v in o) for o in lay)
            if (offs == lay and self.lo[:2] == (r, r)
                    and self.hi[:2] == (r, r)):
                return name
        return None

    def stream(self) -> "DenseStream":
        """Kernel K7's launch (linear taps): the block footprint of least
        estimated cost (:func:`_dense_stream`)."""
        if self.taps is None:
            raise ValueError("kernel K7 takes linear stencils")
        loads = (stream_loads([k[1:] for k, _c in self.taps], K7_LAYOUTS)
                 if self.layout() else float(len(self.taps)))
        return _dense_stream(self.shape, self.pad, self.lo, self.hi,
                             len(self.fields), len(self.taps), loads)


@dataclass(frozen=True)
class DenseStream:
    """K7's launch as :meth:`DensePlan.stream` plans it.  Over the output
    rows ``[pk, SK - pk)`` x ``[pj, SJ - pj)`` of the padded ``shape``, a
    block owns a chunk of ``kch`` k rows, ``tj`` j rows and ``ti`` i lanes
    and walks its chunk in k; each input plane comes into a ring of ``lo[0]
    + hi[0] + 1 + d`` planes per field (``d`` loaded ahead), ``tj + lo[1] +
    hi[1]`` rows of ``ti + 2h`` floats each.  ``smem_bytes`` is the
    launch's dynamic shared memory."""

    shape: tuple
    pad: tuple
    lo: tuple
    hi: tuple
    nf: int
    kch: int
    tj: int
    ti: int
    h: int
    d: int
    smem_bytes: int

    @property
    def nchunk(self) -> int:
        return -(-(self.shape[0] - 2 * self.pad[0]) // self.kch)

    @property
    def njg(self) -> int:
        return -(-(self.shape[1] - 2 * self.pad[1]) // self.tj)

    @property
    def nit(self) -> int:
        return self.shape[2] // self.ti

    @property
    def nblocks(self) -> int:
        return self.nchunk * self.njg * self.nit

    def blocks(self) -> list:
        """Every block of the launch in grid order, decoded as the kernel
        decodes it: ``(computed, written)``, each a box ``((k0, k1), (j0,
        j1), (i0, i1))`` of the padded array; the block computes the first
        and writes zeros to the rest of the second (the pad rows of its i
        tile where it is the first or last chunk or j group)."""
        (SK, SJ, _SI), (pk, pj, _pi) = self.shape, self.pad
        out = []
        for b in range(self.nblocks):
            it, b = b % self.nit, b // self.nit
            jg, ch = b % self.njg, b // self.njg
            k0 = pk + ch * self.kch
            k1 = min(k0 + self.kch, SK - pk)
            j0 = pj + jg * self.tj
            j1 = min(j0 + self.tj, SJ - pj)
            i = (it * self.ti, (it + 1) * self.ti)
            written = ((0 if ch == 0 else k0,
                        SK if ch == self.nchunk - 1 else k1),
                       (0 if jg == 0 else j0,
                        SJ if jg == self.njg - 1 else j1), i)
            out.append((((k0, k1), (j0, j1), i), written))
        return out


def dense_smem(nf: int, lo, hi, tj: int, ti: int, h: int, d: int) -> int:
    """Dynamic shared memory of one K7 block, as ``csrc/dense_stencil.cu``
    lays it out (``k7_smem_bytes``): per field a ring of ``lo[0] + hi[0] +
    1 + d`` planes of ``tj + lo[1] + hi[1]`` rows of ``ti + 2h`` floats."""
    return 4 * nf * (lo[0] + hi[0] + 1 + d) * (tj + lo[1] + hi[1]) \
        * (ti + 2 * h)


@lru_cache(maxsize=256)
def _dense_stream(shape, pad, lo, hi, nf: int, ntaps: int, loads: float,
                  budget: int = STREAM_SMEM_BUDGET) -> DenseStream:
    """The footprint (k chunk, j rows, i lanes, planes ahead) of least
    estimated cost, in K1's cost model (``codegen/pencil_kernel.py``): per
    wave of blocks over :data:`SM_COUNT` SMs, the level-0 floats loaded,
    the shared-memory accesses of the outputs and each block's steps and
    start."""
    (SK, SJ, SI), (pk, pj, _pi) = shape, pad
    NK, NJ = SK - 2 * pk, SJ - 2 * pj
    h = -(-max(lo[2], hi[2]) // 4) * 4
    rk, rj = lo[0] + hi[0], lo[1] + hi[1]
    chunks = sorted(c for c in {-(-NK // n) for n in range(1, NK + 1)}
                    if c <= K7_MAX_KCH)
    lookaheads = (2,) if ntaps < 40 else (2, 1)
    # shared-memory accesses per output: its loads, a tap's address per
    # quad of rows, its store
    per_out = loads + 1 + ntaps / STREAM_ROWS
    best = None
    for ti in (t for t in range(32, SI + 1, 32) if SI % t == 0):
        rw = ti + 2 * h
        for tj in range(STREAM_ROWS, min(NJ, K7_MAX_TJ) + 1, STREAM_ROWS):
            for kch in chunks:
                work = (LOAD_COST * nf * (tj + rj) * rw * (kch + rk)
                        + tj * ti * kch * per_out)
                nblocks = -(-NK // kch) * -(-NJ // tj) * (SI // ti)
                stall = (kch + rk) * STEP_COST + BLOCK_COST
                for d in lookaheads:
                    smem = dense_smem(nf, lo, hi, tj, ti, h, d)
                    if smem > budget:
                        continue
                    bps = min(SM_SMEM // (smem + SM_BLOCK_RESERVE),
                              SM_THREADS // STREAM_THREADS)
                    waves = -(-nblocks // (SM_COUNT * bps))
                    cost = (waves * (bps * work + stall), -d, -ti, kch)
                    if best is None or cost < best[0]:
                        best = (cost, (kch, tj, ti, d, smem))
    if best is None:
        raise ValueError(f"no K7 block of {nf} fields fits {budget} bytes "
                         "of shared memory")
    kch, tj, ti, d, smem = best[1]
    return DenseStream(shape, pad, lo, hi, nf, kch, tj, ti, h, d, smem)


def dense_stencil_plain(arrs: Sequence[torch.Tensor],
                        plan: DensePlan) -> torch.Tensor:
    """The plain PyTorch version of kernel K7, on any device and for any
    stencil: every tap a slice in k and j and a ``torch.roll`` over the
    whole padded i row, through the copied executor; the pad rows zero."""
    pk, pj, _pi = plan.pad
    SK, SJ, _SI = plan.shape
    NK, NJ = SK - 2 * pk, SJ - 2 * pj
    uidx = {n: f for f, n in enumerate(plan.fields)}

    def read_tap(name, offs_edsl):
        dk, dj, di = _np_offsets(offs_edsl, 3)
        v = arrs[uidx[name]][pk + dk:pk + dk + NK, pj + dj:pj + dj + NJ]
        return torch.roll(v, -di, dims=2) if di else v

    out = torch.zeros(plan.shape, dtype=arrs[0].dtype, device=arrs[0].device)
    val = _run(plan.ir, read_tap, resolve_const_from_params(plan.params),
               TorchNS)
    out[pk:SK - pk, pj:SJ - pj] = val
    return out


def dense_stencil_kernel(arrs: Sequence[torch.Tensor],
                         plan: DensePlan) -> torch.Tensor:
    """Launch kernel K7 on CUDA tensors, as :meth:`DensePlan.stream` plans
    it; returns a fresh padded array."""
    return launch_dense(arrs, plan, None)


def launch_dense(arrs: Sequence[torch.Tensor], plan: DensePlan,
                 sp: DenseStream | None) -> torch.Tensor:
    """K7 at ``sp``'s footprint (``None``: the planner's), its shared
    memory counted again from the footprint."""
    dev = arrs[0].device
    if dev.type != "cuda" or any(a.device != dev for a in arrs):
        raise ValueError("kernel K7 takes arrays on one CUDA device, got "
                         f"{[str(a.device) for a in arrs]}")
    if plan.taps is None:
        raise not_ported("a nonlinear dense stencil on a CUDA tensor",
                         FEATURES_ITEM)
    for a in arrs:
        if (a.dtype != torch.float32 or tuple(a.shape) != plan.shape
                or not a.is_contiguous()):
            raise ValueError(f"arrays must be contiguous float32 "
                             f"{list(plan.shape)}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if len(arrs) > K7_MAX_FIELDS or len(plan.taps) > K7_MAX_TAPS:
        raise ValueError(f"kernel K7 takes at most {K7_MAX_FIELDS} inputs "
                         f"and {K7_MAX_TAPS} taps")
    SK, SJ, SI = plan.shape
    if SK * SJ * SI >= 2 ** 31:
        raise ValueError("kernel K7 takes arrays of fewer than 2^31 "
                         "elements")
    if sp is None:
        sp = plan.stream()
    smem = dense_smem(len(arrs), plan.lo, plan.hi, sp.tj, sp.ti, sp.h, sp.d)
    f, dk, dj, di = (np.ascontiguousarray(a, np.int32) for a in
                     zip(*(k for k, _c in plan.taps)))
    c = np.asarray([c for _k, c in plan.taps], np.float32)
    ins = np.asarray([a.data_ptr() for a in arrs], np.int64)
    # 16-byte pieces need 16-byte aligned inputs (a view may start anywhere)
    pw = 4 if all(a.data_ptr() % 16 == 0 for a in arrs) else 1
    out = torch.empty_like(arrs[0])
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    err = _build.library().bt_dense_stencil(
        ins.ctypes.data, out.data_ptr(), len(arrs), SK, SJ, SI, plan.pad[0],
        plan.pad[1], klo, khi, jlo, jhi, ilo, ihi, sp.kch, sp.tj, sp.ti,
        sp.h, pw, sp.d, len(c), f.ctypes.data, dk.ctypes.data,
        dj.ctypes.data, di.ctypes.data, c.ctypes.data, smem,
        STREAM_THREADS, _build.stream_handle(dev))
    _build.check(err, "dense_stencil")
    dense_stencil_kernel.launches += 1
    return out


dense_stencil_kernel.launches = 0


def dense_stencil(stencil, shape: Sequence[int],
                  padding: Sequence[int],
                  params: dict | None = None,
                  tile_elems: Sequence[int] | None = None,
                  dtype=torch.float32,
                  interpret: bool | None = None,
                  vmem_limit_bytes: int = 100 * 2 ** 20):
    """Build ``fn(arr) -> arr_out`` over a padded dense array (or
    ``fn(*arrs)`` for a multi-input stencil, with ``fn.fields``).

    Arguments and errors follow ``pallas_dense_stencil``
    (``bricklib_tpu/codegen/pallas_backend.py:128``).  Storage types other
    than float32 raise ``NotImplementedError``; a nonlinear stencil runs on
    CPU tensors only."""
    ir = as_ir(stencil)
    params = dict(params or {})
    dims = ir.dims
    if dims != 3:
        raise NotImplementedError("dense pallas path is 3-D for now")
    shape = tuple(int(s) for s in shape)
    pad = tuple(int(p) for p in padding)
    lo, hi = ir.radius()
    for a in range(dims):
        if pad[a] < max(lo[a], hi[a]):
            raise ValueError("padding smaller than stencil radius")
    if shape[2] % 128:
        raise ValueError("innermost padded extent must be a multiple of "
                         "128 (choose pad[2] accordingly)")
    interior = tuple(shape[a] - 2 * pad[a] for a in range(dims))
    if tile_elems is None:
        tk = next(t for t in (32, 16, 8, 4, 2, 1) if interior[0] % t == 0)
        tj = next(t for t in (64, 32, 16, 8) if interior[1] % t == 0)
        tile_elems = (tk, tj)
    TKE, TJE = (int(t) for t in tile_elems)
    if interior[0] % TKE or interior[1] % TJE:
        raise ValueError(f"tile {tile_elems} must divide interior")
    if TJE % 8:
        raise ValueError("j tile must be a sublane multiple (8)")
    jlo = -(-lo[1] // 8) * 8
    jhi = -(-hi[1] // 8) * 8
    if pad[1] < jlo or pad[1] < jhi:
        raise ValueError("pad[1] must cover the sublane-rounded j halo")
    if not _is_f32(dtype):
        raise not_ported("storage types other than float32", FEATURES_ITEM)
    fieldnames = tuple(ir.sdef.inputs)
    NF = len(fieldnames)
    plan = DensePlan(
        shape=shape, pad=pad, lo=tuple(int(v) for v in lo),
        hi=tuple(int(v) for v in hi), fields=fieldnames, ir=ir,
        params=params, taps=fold_linear_forms(ir, fieldnames, params))

    args = trace.sweep_args("K7")

    def run(arrs):
        for a in arrs:
            if tuple(a.shape) != shape:
                raise ValueError(f"array shape {tuple(a.shape)} is not "
                                 f"{shape}")
        with trace.span(trace.SWEEP, args):
            if arrs[0].device.type == "cpu":
                return dense_stencil_plain(arrs, plan)
            return dense_stencil_kernel(arrs, plan)

    if NF > 1:
        def fn(*arrs):
            if len(arrs) != NF:
                raise TypeError(f"stencil reads {NF} grids "
                                f"({list(fieldnames)}), got {len(arrs)}")
            return run(arrs)
        fn.fields = fieldnames
    else:
        def fn(arr):
            return run((arr,))

    fn.plan = plan
    return fn
