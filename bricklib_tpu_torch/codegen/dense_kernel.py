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
(field, dk, dj, di), or raises.  The reference's TPU alignment rules
(padded i extent a multiple of 128, tiles dividing the interior, j tile
and j pad in whole 8-row sublanes) are kept as checks, so both packages
accept and refuse the same calls; ``tile_elems`` and ``vmem_limit_bytes``
change nothing here.  ``pallas_brick_stencil`` (the i-bricked wrapper of
kernel 1) is not ported: :func:`brick_stencil` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .evaluate import TorchNS, resolve_const_from_params
from .jnp_backend import _np_offsets, _run
from .pencil_kernel import FEATURES_ITEM, _is_f32
from .pencil_kernel_2d import fold_linear_forms
from .taps import as_ir

__all__ = ["K7_SMEM_BUDGET", "K7_THREADS", "DensePlan", "brick_stencil",
           "choose_tile", "dense_stencil", "dense_stencil_kernel",
           "dense_stencil_plain"]

K7_THREADS = 256
# shared memory per block: 100 KiB lets two blocks share one SM
K7_SMEM_BUDGET = 100 * 1024
K7_TJ, K7_TI = 8, 128       # j rows and i columns per block (in the .cu)
K7_TK = (8, 4, 2, 1)        # k rows per block, the first that fits
K7_MAX_FIELDS = 8
K7_MAX_TAPS = 128


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

    def tile_k(self) -> tuple[int, int]:
        """(k rows per block, shared-memory bytes) for kernel K7: the
        first of :data:`K7_TK` whose input tiles fit
        :data:`K7_SMEM_BUDGET`."""
        ej = K7_TJ + self.lo[1] + self.hi[1]
        ei = K7_TI + self.lo[2] + self.hi[2]
        for tk in K7_TK:
            nbytes = 4 * len(self.fields) * (tk + self.lo[0] + self.hi[0]) \
                * ej * ei
            if nbytes <= K7_SMEM_BUDGET:
                return tk, nbytes
        raise ValueError(f"no k tile fits {K7_SMEM_BUDGET} bytes of shared "
                         f"memory with {len(self.fields)} fields")


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
    """Launch kernel K7 on CUDA tensors; returns a fresh padded array."""
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
    tk, smem = plan.tile_k()
    f, dk, dj, di = (np.ascontiguousarray(a, np.int32) for a in
                     zip(*(k for k, _c in plan.taps)))
    c = np.asarray([c for _k, c in plan.taps], np.float32)
    ins = np.asarray([a.data_ptr() for a in arrs], np.int64)
    out = torch.empty_like(arrs[0])
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    err = _build.library().bt_dense_stencil(
        ins.ctypes.data, out.data_ptr(), len(arrs), SK, SJ, SI, plan.pad[0],
        plan.pad[1], klo, khi, jlo, jhi, ilo, ihi, tk, len(c),
        f.ctypes.data, dk.ctypes.data, dj.ctypes.data, di.ctypes.data,
        c.ctypes.data, smem, K7_THREADS, _build.stream_handle(dev))
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

    def run(arrs):
        for a in arrs:
            if tuple(a.shape) != shape:
                raise ValueError(f"array shape {tuple(a.shape)} is not "
                                 f"{shape}")
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
