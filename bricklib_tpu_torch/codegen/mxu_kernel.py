"""The flat-pencil factorized sweep on PyTorch (port of
``bricklib_tpu/codegen/mxu_kernel.py``).

:func:`pencil_sweep_mxu` has the meaning of the reference's
``pallas_pencil_sweep_mxu``: storage is FLAT-PENCIL, ``[nbricks, BK,
BJ*BI]`` (each brick's (j, i) plane one row, the same element order as
``[nbricks, BK, BJ, BI]``), read through a pencil table ``T[GK, GJ]``.  The
sweep computes a linear single-input 3-D stencil at fuse 1 over the brick
rows ``k_range`` x pencils ``j_range`` in the factorized form of
:func:`.ir.fold_linear`:

- W: each distinct k-profile over the three k-slots (grid rows k-1, k,
  k+1), the reference's ``A_prev``/``A_cur``/``A_next`` contraction
  (:func:`_slot_matrices`);
- V: per distinct ``di``, the j-shifted sums of the W rows (lane slices at
  multiples of BI over the window of pencils j-1, j, j+1);
- out: the V terms shifted by ``di``, periodic within each BI-wide brick
  row.

Window rows and pencils clamp to the table edge; they do not wrap.  Bricks
outside ``k_range`` x ``j_range`` are not written and are undefined.  The
result equals the pencil sweep at fuse 1 on the same table
(:func:`.pencil_kernel.pencil_sweep`).

A CPU tensor takes :func:`pencil_sweep_mxu_plain`, which spells the
factorized form out with ``torch.matmul``; a CUDA tensor launches kernel
K8 (``csrc/pencil_sweep_mxu.cu``) or raises.  ``tile_j``, ``lookahead``,
``vmem_limit_bytes`` and ``interpret`` are TPU scheduling arguments,
accepted and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from .evaluate import resolve_const_from_params
from .ir import fold_linear
from .pencil_kernel import FEATURES_ITEM, _is_f32, check_table
from .taps import as_ir

__all__ = ["K8_RADII", "K8_SMEM_BUDGET", "K8_THREADS", "MxuPlan",
           "flatten_bricks", "pencil_sweep_mxu", "pencil_sweep_mxu_kernel",
           "pencil_sweep_mxu_plain", "unflatten_bricks"]

K8_THREADS = 256
# shared memory per block: 76 KiB lets three blocks share one SM
K8_SMEM_BUDGET = 76 * 1024
K8_ROWS = 4                 # output rows per chunk (K8_R in the .cu)
K8_RADII = (1, 2, 4, 8)     # k radii K8 is compiled for
MAX_TILE_I = 128
K8_MAX_W = 24
K8_MAX_DI = 17
K8_MAX_TERMS = 128


def flatten_bricks(view: torch.Tensor) -> torch.Tensor:
    """``[nbricks, BK, BJ, BI]`` -> ``[nbricks, BK, BJ*BI]``, a view (no
    copy) of a contiguous tensor."""
    nb, bk, bj, bi = view.shape
    return view.view(nb, bk, bj * bi)


def unflatten_bricks(view: torch.Tensor, bdims) -> torch.Tensor:
    """``[nbricks, BK, BJ*BI]`` -> ``[nbricks, *bdims]``, a view."""
    return view.view((view.shape[0],) + tuple(int(b) for b in bdims))


def _slot_matrices(wdefs, BK, lo0, hi0):
    """A_prev/A_cur/A_next (nW*BK, BK) f32: row w*BK+r accumulates
    coefficient c into the column holding slab row r+dk (prev slot
    rows are its last lo0, next slot rows its first hi0).

    Original: ``bricklib_tpu/codegen/mxu_kernel.py:_slot_matrices``."""
    nW = len(wdefs)
    Ap = np.zeros((nW * BK, BK), np.float32)
    Ac = np.zeros((nW * BK, BK), np.float32)
    An = np.zeros((nW * BK, BK), np.float32)
    for w, terms in enumerate(wdefs):
        for c, dks in terms:
            for fr in dks:
                (dk,) = fr
                for r in range(BK):
                    a = r + dk
                    if a < 0:
                        Ap[w * BK + r, BK + a] += c
                    elif a < BK:
                        Ac[w * BK + r, a] += c
                    else:
                        An[w * BK + r, a - BK] += c
    return Ap, Ac, An


@dataclass(frozen=True)
class MxuPlan:
    """Everything static about one flat-pencil sweep: brick shape, the
    pencil table, the output ranges, the stencil's reach (k radius per
    side, the folded j reach, i radius per side), the folded form
    (``wdefs``, ``vmap``) and its slot matrices."""

    bdims: tuple
    table: np.ndarray
    ranges: tuple
    klo: int
    khi: int
    jlo: int
    jhi: int
    ilo: int
    ihi: int
    wdefs: tuple
    vmap: tuple                 # ((di, ((dj, wid), ...)), ...), di sorted
    slots: tuple                # (A_prev, A_cur, A_next)

    # the pencil-sweep plan interface (check_table, written_bricks)
    batch = 1
    batch_stride = 0

    def written_bricks(self) -> np.ndarray:
        """Storage ids this sweep writes (sorted, unique)."""
        (K0, K1), (J0, J1) = self.ranges
        return np.unique(self.table[K0:K1, J0:J1])

    def rk(self) -> int:
        """The k radius K8 is compiled for that covers this stencil."""
        need = max(self.klo, self.khi, 1)
        for r in K8_RADII:
            if r >= need:
                return r
        raise ValueError(f"kernel K8 takes a k radius of at most "
                         f"{K8_RADII[-1]}, got {need}")

    def tile(self) -> tuple[int, int]:
        """(i lanes per block, shared-memory bytes) for kernel K8: the
        widest divisor of BI, at most :data:`MAX_TILE_I`, whose slab, W
        buffer and row offsets fit :data:`K8_SMEM_BUDGET`."""
        BK, BJ, BI = self.bdims
        rk = self.rk()
        jpe = BJ + self.jlo + self.jhi
        sr = -(-BK // K8_ROWS) * K8_ROWS + 2 * rk
        rows = sr + len(self.wdefs) * K8_ROWS
        for ti in range(min(BI, MAX_TILE_I), 0, -1):
            if BI % ti:
                continue
            floats = rows * jpe * (ti + self.ilo + self.ihi)
            nbytes = 4 * ((floats + 1) & ~1) + 8 * sr * jpe
            if nbytes <= K8_SMEM_BUDGET:
                return ti, nbytes
        raise ValueError(f"no i tile of BI={BI} fits {K8_SMEM_BUDGET} bytes "
                         f"of shared memory with {len(self.wdefs)} "
                         "k-profiles")

    def coefficients(self) -> np.ndarray:
        """K8's W stage: per k-profile its coefficient per dk in
        ``[-rk, rk]``, float32 ``[nW * (2 rk + 1)]``."""
        rk = self.rk()
        c = np.zeros((len(self.wdefs), 2 * rk + 1), np.float32)
        for w, terms in enumerate(self.wdefs):
            for coeff, dks in terms:
                for (dk,) in dks:
                    c[w, dk + rk] += coeff
        return c.reshape(-1)

    def n_ktaps(self) -> int:
        """Non-zero slot-matrix entries per row: the k-taps of every
        profile, summed."""
        return sum(len(dks) for terms in self.wdefs for _c, dks in terms)

    def flops_per_output(self) -> int:
        """The least f32 operations per output element of the factorized
        form (each W element computed once): a multiply and an add per
        k-tap, an add per V term and per di."""
        nterms = sum(len(t) for _di, t in self.vmap)
        return 2 * self.n_ktaps() + nterms + len(self.vmap)


def pencil_sweep_mxu_plain(x: torch.Tensor, table: torch.Tensor,
                           plan: MxuPlan) -> torch.Tensor:
    """The plain PyTorch version of kernel K8, on any device: the three
    k-slots gathered through the table as ``[rows, BK, window lanes]``, W
    as three ``torch.matmul``s with the slot matrices, the V sums as lane
    slices at multiples of BI, the i shifts as ``torch.roll`` within each
    BI block.  Returns a fresh storage whose unwritten bricks are
    undefined."""
    BK, BJ, BI = plan.bdims
    LB = BJ * BI
    (K0, K1), (J0, J1) = plan.ranges
    KC, JC = K1 - K0, J1 - J0
    GK, GJ = plan.table.shape
    dev = x.device
    ids = table.long()
    krows = torch.arange(K0 - 1, K1 + 1, device=dev).clamp(0, GK - 1)
    jcols = torch.arange(J0 - 1, J1 + 1, device=dev).clamp(0, GJ - 1)
    # slab[g] holds grid row K0 - 1 + g, its pencils side by side
    slab = x[ids[krows][:, jcols]].permute(0, 2, 1, 3).reshape(
        KC + 2, BK, (JC + 2) * LB)
    Ap, Ac, An = (torch.from_numpy(a).to(device=dev, dtype=x.dtype)
                  for a in plan.slots)
    W2 = torch.matmul(Ac, slab[1:KC + 1])
    if plan.slots[0].any():
        W2 = W2 + torch.matmul(Ap, slab[0:KC])
    if plan.slots[2].any():
        W2 = W2 + torch.matmul(An, slab[2:KC + 2])
    LO = JC * LB
    out = None
    vcache: dict = {}
    for di, terms in plan.vmap:
        V = vcache.get(terms)
        if V is None:
            for dj, wid in terms:
                s = W2[:, wid * BK:(wid + 1) * BK,
                       (BJ + dj) * BI:(BJ + dj) * BI + LO]
                V = s if V is None else V + s
            vcache[terms] = V
        term = V
        if di:
            term = torch.roll(V.reshape(KC, BK, JC * BJ, BI), -di,
                              dims=3).reshape(KC, BK, LO)
        out = term if out is None else out + term
    vals = out.reshape(KC, BK, JC, LB).permute(0, 2, 1, 3).reshape(
        KC * JC, BK, LB)
    res = torch.empty_like(x)
    res[ids[K0:K1, J0:J1].reshape(-1)] = vals
    return res


def pencil_sweep_mxu_kernel(x: torch.Tensor, table: torch.Tensor,
                            plan: MxuPlan) -> torch.Tensor:
    """Launch kernel K8 on CUDA tensors; returns a fresh output whose
    unwritten bricks are undefined."""
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("kernel K8 takes storage and table on one CUDA "
                         f"device, got {x.device} and {table.device}")
    BK, BJ, BI = plan.bdims
    GK, GJ = plan.table.shape
    if (x.dtype != torch.float32 or x.dim() != 3
            or tuple(x.shape[1:]) != (BK, BJ * BI) or not x.is_contiguous()):
        raise ValueError(f"storage must be contiguous float32 [nb, {BK}, "
                         f"{BJ * BI}], got {x.dtype} {tuple(x.shape)}")
    if (table.dtype != torch.int32 or tuple(table.shape) != (GK, GJ)
            or not table.is_contiguous()):
        raise ValueError(f"table must be contiguous int32 [{GK}, {GJ}]")
    nterms = sum(len(t) for _di, t in plan.vmap)
    if (len(plan.wdefs) > K8_MAX_W or len(plan.vmap) > K8_MAX_DI
            or nterms > K8_MAX_TERMS):
        raise ValueError(f"kernel K8 takes at most {K8_MAX_W} k-profiles, "
                         f"{K8_MAX_DI} distinct di and {K8_MAX_TERMS} V "
                         "terms")
    (K0, K1), (J0, J1) = plan.ranges
    if K1 - K0 > 65535 or J1 - J0 > 65535:
        raise ValueError("kernel K8 takes at most 65535 brick rows and "
                         "pencils")
    ti, smem = plan.tile()
    coef = plan.coefficients()
    di = np.asarray([d for d, _t in plan.vmap], np.int32)
    tbeg = np.cumsum([0] + [len(t) for _d, t in plan.vmap]).astype(np.int32)
    tdj = np.asarray([dj for _d, t in plan.vmap for dj, _w in t], np.int32)
    tw = np.asarray([w for _d, t in plan.vmap for _dj, w in t], np.int32)
    out = torch.empty_like(x)
    err = _build.library().bt_pencil_sweep_mxu(
        x.data_ptr(), out.data_ptr(), table.data_ptr(), GK, GJ, BK, BJ, BI,
        K0, K1, J0, J1, plan.jlo, plan.jhi, plan.ilo, plan.ihi, ti,
        plan.rk(), len(plan.wdefs), coef.ctypes.data, len(di),
        di.ctypes.data, tbeg.ctypes.data, tdj.ctypes.data, tw.ctypes.data,
        smem, K8_THREADS, _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_mxu")
    pencil_sweep_mxu_kernel.launches += 1
    return out


pencil_sweep_mxu_kernel.launches = 0


def pencil_sweep_mxu(stencil, grid: np.ndarray,
                     bdims: Sequence[int],
                     nbricks: int,
                     params: dict | None = None,
                     k_range: tuple[int, int] | None = None,
                     j_range: tuple[int, int] | None = None,
                     tile_j: int | None = None,
                     dtype=torch.float32,
                     interpret: bool | None = None,
                     lookahead: int = 2,
                     vmem_limit_bytes: int = 110 * 2 ** 20):
    """Build the flat-pencil sweep; returns ``fn(flat_view) -> flat_view``
    over ``[nbricks, BK, BJ*BI]`` storage (see :func:`flatten_bricks`).

    Arguments and errors follow ``pallas_pencil_sweep_mxu``
    (``bricklib_tpu/codegen/mxu_kernel.py:93``), but for its
    hardware-only rule (``BI % 128``, ``BJ % 8``), which is the TPU's tile
    shape.  bf16 storage raises ``NotImplementedError``."""
    ir = as_ir(stencil)
    params = dict(params or {})
    if ir.dims != 3:
        raise NotImplementedError("mxu path is 3-D")
    if len(ir.sdef.inputs) != 1:
        raise NotImplementedError("mxu path is single-input")
    lin = fold_linear(ir, resolve_const_from_params(params))
    if lin is None:
        raise NotImplementedError("mxu path needs a linear stencil")
    wdefs, vmap_, (jlo, jhi) = lin
    BK, BJ, BI = (int(b) for b in bdims)
    lo, hi = ir.radius()
    if lo[0] > BK or hi[0] > BK:
        raise ValueError("k radius exceeds brick depth")
    if jlo > BJ or jhi > BJ:
        raise ValueError("j radius exceeds one pencil column")
    if lo[2] >= BI or hi[2] >= BI:
        raise ValueError("i radius exceeds brick i width")
    if str(dtype).rsplit(".", 1)[-1] == "bfloat16":
        raise not_ported("bf16 flat-pencil storage", FEATURES_ITEM)
    if not _is_f32(dtype):
        raise NotImplementedError("mxu path stores f32 or bf16")
    grid = np.asarray(grid)
    if grid.ndim == 3:
        if grid.shape[2] != 1:
            raise NotImplementedError("mxu path is pencil-only (GI==1)")
        grid = grid[:, :, 0]
    GK, GJ = grid.shape
    if k_range is None:
        k_range = (1, GK - 1)
    if j_range is None:
        j_range = (1, GJ - 1)
    K0, K1 = (int(k) for k in k_range)
    J0, J1 = (int(j) for j in j_range)
    if not (0 <= K0 < K1 <= GK and 0 <= J0 < J1 <= GJ):
        raise ValueError("range outside grid table")
    if int(lookahead) < 1:
        raise ValueError("lookahead must be >= 1")
    if tile_j is not None and (J1 - J0) % int(tile_j):
        raise ValueError(f"tile_j {int(tile_j)} must divide j extent "
                         f"{J1 - J0}")
    plan = MxuPlan(
        bdims=(BK, BJ, BI), table=np.ascontiguousarray(grid, np.int32),
        ranges=((K0, K1), (J0, J1)), klo=int(lo[0]), khi=int(hi[0]),
        jlo=int(jlo), jhi=int(jhi), ilo=int(lo[2]), ihi=int(hi[2]),
        wdefs=tuple(tuple(t) for t in wdefs),
        vmap=tuple(sorted(vmap_.items())),
        slots=_slot_matrices(wdefs, BK, lo[0], hi[0]))
    check_table(plan, nbricks)
    shape = (int(nbricks), BK, BJ * BI)
    tables: dict = {}

    def fn(flat_view: torch.Tensor) -> torch.Tensor:
        if tuple(flat_view.shape) != shape:
            raise ValueError(f"storage shape {tuple(flat_view.shape)} is not "
                             f"{shape}")
        dev = flat_view.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
        if dev.type == "cpu":
            return pencil_sweep_mxu_plain(flat_view, tables[dev], plan)
        return pencil_sweep_mxu_kernel(flat_view, tables[dev], plan)

    fn.plan = plan
    fn.n_wprofiles = len(wdefs)
    return fn
