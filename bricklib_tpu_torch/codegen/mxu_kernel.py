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
K8 (``csrc/pencil_sweep_mxu.cu``, k-streaming blocks as
:meth:`MxuPlan.stream` plans them) or raises.  ``tile_j``, ``lookahead``,
``vmem_limit_bytes`` and ``interpret`` are TPU scheduling arguments,
accepted and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..core import not_ported
from .evaluate import resolve_const_from_params
from .ir import fold_linear
from .pencil_kernel import FEATURES_ITEM, _is_f32, check_table
from .taps import as_ir

__all__ = ["K8_RADII", "K8_SMEM_BUDGET", "MXU_LAYOUT_125", "MxuPlan",
           "MxuStreamPlan", "flatten_bricks", "launch_mxu", "mxu_footprint",
           "mxu_smem", "pencil_sweep_mxu", "pencil_sweep_mxu_kernel",
           "pencil_sweep_mxu_plain", "unflatten_bricks"]

# K8's k-streaming blocks (csrc/mxu_stream.cuh) on the H100: the shared
# memory one block may take (227 KB), output j rows of a warp's strip
# (MX_UR), threads per block at most, and the SMs to fill
K8_SMEM_BUDGET = 232448
K8_STRIP = 8
K8_GENERIC_W = 4            # generic W stage: elements a thread at once
K8_MAX_THREADS = 512
K8_RADII = (1, 2, 4, 8)     # coefficient k radii K8 takes
K8_MAX_W = 24
K8_MAX_DI = 17
K8_MAX_TERMS = 128
# the planner's costs in SM clocks: thread instructions issue at 128 a
# clock with 16 warps or more resident (fewer leave the schedulers idle in
# proportion), a level-0 float loaded costs as much as 8 (shared memory
# and L2 bandwidth); a step's barrier and set-up; a block's start (its
# brick table and the first planes' latency); registers a thread holds
# (the compiled layout's body: 117, allocated in eights).  Fitted to K8's
# footprints at 512^3 on the H100 (bench/k8_regimes.py --footprints): the
# planner's pick within 5% of the best of each sweep.
ISSUE_RATE, FULL_WARPS, LOAD_INSTR = 128, 16, 8
STEP_CLOCKS, BLOCK_CLOCKS = 150, 1000
SM_COUNT, SM_SMEM, SM_BLOCK_RESERVE, SM_THREADS = 132, 233472, 1024, 2048
MAX_REGS = 120
PLANE_SPAN = 1 << 20
# the folded form K8 compiles in (LayoutMxu125 in csrc/mxu_stream.cuh):
# mpi125pt's under ir.fold_linear, every profile's k taps dk -2..2
# non-zero; the distinct V term lists (dj, profile) in order of first use
# over the sorted di, and each di's list
MXU_LAYOUT_125 = {
    "nw": 6, "rk": 2, "jreach": (2, 2), "di": (-2, -1, 0, 1, 2),
    "dtup": (0, 1, 2, 1, 0),
    "tuples": (((-2, 0), (-1, 1), (0, 2), (1, 1), (2, 0)),
               ((-2, 1), (-1, 3), (0, 4), (1, 3), (2, 1)),
               ((-2, 2), (-1, 4), (0, 5), (1, 4), (2, 2))),
}


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

    def folded(self) -> dict:
        """K8's folded form as it takes it: the distinct V term lists
        (tuples) in order of first use over the sorted di, each di's
        tuple, and the lists' terms ``(dj, profile)`` in order."""
        tuples: list = []
        dtup = []
        for _di, terms in self.vmap:
            if terms not in tuples:
                tuples.append(terms)
            dtup.append(tuples.index(terms))
        return {"nw": len(self.wdefs), "rk": self.rk(),
                "jreach": (self.jlo, self.jhi),
                "di": tuple(d for d, _t in self.vmap), "dtup": tuple(dtup),
                "tuples": tuple(tuples)}

    def layout(self) -> bool:
        """The folded form equals the one K8 compiles in
        (:data:`MXU_LAYOUT_125`), with every coefficient non-zero, every
        profile even in dk and the k reach its radius: the entry point
        then runs that body."""
        c = self.coefficients().reshape(len(self.wdefs), -1)
        return (self.folded() == MXU_LAYOUT_125
                and (self.klo, self.khi) == (2, 2)
                and bool(np.all(c != 0))
                and np.array_equal(c, c[:, ::-1]))

    def stream(self) -> "MxuStreamPlan":
        """Kernel K8's launch: the block footprint (k chunk, pencils, lane
        chunks, lookahead) of least estimated cost over :data:`SM_COUNT`
        SMs whose shared memory fits :data:`K8_SMEM_BUDGET`."""
        terms = sum(len(t) for t in self.folded()["tuples"])
        return _mxu_stream_plan(
            self.bdims, self.ranges, (self.klo, self.jlo, self.ilo),
            (self.khi, self.jhi, self.ihi), len(self.wdefs), self.n_ktaps(),
            terms, len(self.vmap), self.layout())

    def loads(self, sp: "MxuStreamPlan | None" = None) -> dict:
        """Per output element at ``sp``'s footprint (the planner's by
        default): ``level0``, the level-0 floats a block loads (its j, i
        and k margins); ``shared``, the shared-memory loads of the compiled
        layout's W and V stages (each strip row's k taps once, over the
        warps' 32 lanes, 32 - ilo - ihi of them outputs), or of the generic
        body's (each non-zero k tap per plane element, each V term per
        output lane and di); ``per_row``, the layout's loads per V row."""
        sp = self.stream() if sp is None else sp
        BK, BJ, BI = self.bdims
        rk, rj = self.klo + self.khi, self.jlo + self.jhi
        (K0, K1), (J0, J1) = self.ranges
        nout = (K1 - K0) * BK * (J1 - J0) * BJ * BI
        level0 = 0
        lanes = 0
        for (k0, k1), (j0, j1), (i0, i1) in sp.blocks():
            level0 += (((k1 - k0) * BK + rk) * ((j1 - j0) * BJ + rj)
                       * (sp.ti + 2 * sp.h))
            nwarp = min(sp.nwc, -(-(i1 - i0) // sp.ow))
            lanes += (k1 - k0) * BK * (j1 - j0) * BJ * 32 * nwarp
        per_row = (K8_STRIP + rj) * (rk + 1) / K8_STRIP
        if sp.layout:
            shared = per_row * lanes / nout
        else:
            terms = sum(len(t) for _d, t in self.vmap)
            shared = self.n_ktaps() * level0 / nout + terms * lanes / nout
        return {"level0": level0 / nout, "shared": shared,
                "per_row": per_row}

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


@dataclass(frozen=True)
class MxuStreamPlan:
    """K8's launch as :meth:`MxuPlan.stream` plans it.  The output brick
    rows stream in chunks of ``kch`` rows, ``pj`` pencils per block, and
    ``nwc`` lane chunks of ``ow`` output lanes each (``ti = nwc * ow`` i
    lanes per block), one warp per (strip of :data:`K8_STRIP` j rows, lane
    chunk); level 0 is loaded with an i margin of ``h`` lanes per side in
    pieces of ``pw`` floats, ``d`` planes ahead.  ``layout``: the compiled
    body runs (else the generic one, with its W buffers).  ``smem_bytes``
    is the launch's dynamic shared memory."""

    ranges: tuple
    bdims: tuple
    kch: int
    pj: int
    nwc: int
    ow: int
    h: int
    pw: int
    d: int
    layout: bool
    smem_bytes: int

    @property
    def ti(self) -> int:
        return self.nwc * self.ow

    @property
    def threads(self) -> int:
        return 32 * self.nwc * -(-self.pj * self.bdims[1] // K8_STRIP)

    @property
    def nchunk(self) -> int:
        (K0, K1), _ = self.ranges
        return -(-(K1 - K0) // self.kch)

    @property
    def njg(self) -> int:
        (J0, J1) = self.ranges[1]
        return -(-(J1 - J0) // self.pj)

    @property
    def nit(self) -> int:
        return -(-self.bdims[2] // self.ti)

    @property
    def nstream(self) -> int:
        return self.nchunk * self.njg * self.nit

    def blocks(self) -> list:
        """Every block of the launch in grid order, decoded as the kernel
        decodes it: ``((k0, k1), (j0, j1), (i0, i1))`` in brick rows,
        pencils and i lanes (the last i tile cut at BI)."""
        (K0, K1), (J0, J1) = self.ranges
        BI = self.bdims[2]
        out = []
        for b in range(self.nstream):
            it, b = b % self.nit, b // self.nit
            jg, ch = b % self.njg, b // self.njg
            k0, j0 = K0 + ch * self.kch, J0 + jg * self.pj
            out.append(((k0, min(k0 + self.kch, K1)),
                        (j0, min(j0 + self.pj, J1)),
                        (it * self.ti, min((it + 1) * self.ti, BI))))
        return out


def mxu_smem(bdims, lo, hi, kch: int, pj: int, ti: int, h: int, d: int,
             nw_buffers: int) -> int:
    """Dynamic shared memory of one K8 block, laid out as
    ``mxu_stream.cuh`` lays it out: the level-0 ring (``rk + 1 + d``
    planes of ``pj * BJ + rj`` rows by ``ti + 2h`` floats), two W buffers
    of ``nw_buffers`` planes (the generic body), the rows a strip may read
    past them (and the generic W stage's last elements, ``K8_GENERIC_W -
    1`` per thread), the count rounded up to even; then the brick table
    (``(kch + 2) x (pj + 2)`` 64-bit offsets), an int pair per level-0 row
    and two buffers of ``pj * BJ`` 64-bit output row offsets.  ``lo``,
    ``hi``: the reach (k, folded j, i) per side."""
    _BK, BJ, _BI = bdims
    rk, rj = lo[0] + hi[0], lo[1] + hi[1]
    rows, rw = pj * BJ + rj, ti + 2 * h
    ps = rows * rw
    n = (rk + 1 + d) * ps + 2 * nw_buffers * ps
    n += max(K8_STRIP - pj * BJ, 0) * rw
    if nw_buffers:
        n += (K8_GENERIC_W - 1) * 32 * (ti // (32 - lo[2] - hi[2])) \
            * -(-pj * BJ // K8_STRIP)
    n = (n + 1) & ~1
    return 4 * n + 8 * (kch + 2) * (pj + 2) + 8 * rows + 16 * pj * BJ


@lru_cache(maxsize=256)
def _mxu_stream_plan(bdims, ranges, lo, hi, nw: int, nktaps: int,
                     nterms: int, ndi: int, layout: bool,
                     budget: int = K8_SMEM_BUDGET) -> MxuStreamPlan:
    BK, BJ, BI = bdims
    (K0, K1), (J0, J1) = ranges
    nrows, npen = K1 - K0, J1 - J0
    rk, rj = lo[0] + hi[0], lo[1] + hi[1]
    ow = 32 - lo[2] - hi[2]
    if ow < 1:
        raise ValueError(f"kernel K8 takes an i reach below 32 lanes, got "
                         f"{lo[2]} + {hi[2]}")
    pw = 4 if BI % 4 == 0 else 1
    h = -(-max(lo[2], hi[2]) // pw) * pw
    chunks = sorted(c for c in {-(-nrows // n) for n in range(1, nrows + 1)}
                    if (c + 2) * BK + rk + 1 < PLANE_SPAN)
    # thread instructions a warp's lane spends per step: per level-0 row of
    # its strip the k taps' loads, the profiles' FMAs and the V adds (the
    # compiled layout, one FMA a k tap as the costs were fitted; its body
    # now pairs the taps at -dk and +dk), per output row the i stage; the
    # generic body also computes W over the plane into shared memory and
    # reads V's terms back
    per_row = (rk + 1 + nktaps + nterms if layout
               else rk + 1 + nktaps + nw)
    per_out = 2 * ndi + 2 + (0 if layout else nterms)
    best = None
    max_warps = K8_MAX_THREADS // 32
    for pj in range(1, min(npen, max_warps) + 1):
        nstrip = -(-pj * BJ // K8_STRIP)
        for nwc in range(1, max_warps // nstrip + 1):
            ti = nwc * ow
            if ti % pw:
                continue
            nit = -(-BI // ti)
            # warps of a strip live on average over the i tiles (a chunk
            # wholly past BI skips its work)
            live = sum(min(nwc, -(-(BI - it * ti) // ow))
                       for it in range(nit)) / nit
            threads = 32 * nstrip * nwc
            rw = ti + 2 * h
            for kch in chunks:
                L = kch * BK
                work = (L * nstrip * live * 32
                        * ((K8_STRIP + rj) * per_row + K8_STRIP * per_out)
                        + LOAD_INSTR * (pj * BJ + rj) * rw * (L + rk))
                nblocks = -(-nrows // kch) * -(-npen // pj) * nit
                for d in (2, 1):
                    smem = mxu_smem(bdims, lo, hi, kch, pj, ti, h, d,
                                    0 if layout else nw)
                    if smem > budget:
                        continue
                    bps = min(SM_SMEM // (smem + SM_BLOCK_RESERVE),
                              SM_THREADS // threads,
                              65536 // (threads * MAX_REGS))
                    if bps < 1:
                        continue
                    # an SM takes its share of the blocks, bps at a time:
                    # their work shares its issue slots, and each round
                    # pays one block's barriers and start
                    per_sm = -(-nblocks // SM_COUNT)
                    rounds = -(-per_sm // bps)
                    rate = ISSUE_RATE * min(1.0, min(bps, per_sm) * nstrip
                                            * live / FULL_WARPS)
                    cost = (per_sm * work / rate
                            + rounds * ((L + rk) * STEP_CLOCKS
                                        + BLOCK_CLOCKS), -d, threads, kch)
                    if best is None or cost < best[0]:
                        best = (cost, (kch, pj, nwc, d, smem))
    if best is None:
        raise ValueError(f"no K8 k-streaming block of bricks {bdims} fits "
                         f"{budget} bytes of shared memory")
    kch, pj, nwc, d, smem = best[1]
    return MxuStreamPlan(ranges, bdims, kch, pj, nwc, ow, h, pw, d, layout,
                         smem)


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
    """Launch kernel K8 on CUDA tensors, as :meth:`MxuPlan.stream` plans
    it; returns a fresh output whose unwritten bricks are undefined.
    ``pencil_sweep_mxu_kernel.layout_launches`` counts the launches that
    ran the compiled layout's body (``LayoutMxu125``), the program's
    counter ``k8_layout``; each is a K8 launch too."""
    sp = plan.stream()
    out = _launch(x, table, plan, sp)
    pencil_sweep_mxu_kernel.launches += 1
    if sp.layout:
        pencil_sweep_mxu_kernel.layout_launches += 1
    return out


def mxu_footprint(plan: MxuPlan, kch: int, pj: int, nwc: int,
                  d: int) -> MxuStreamPlan:
    """The launch of ``plan`` at another footprint (chunk, pencils, lane
    chunks, lookahead), its shared memory counted from that footprint; for
    measuring the planner's choice against its neighbours."""
    sp = plan.stream()
    lo, hi = (plan.klo, plan.jlo, plan.ilo), (plan.khi, plan.jhi, plan.ihi)
    return MxuStreamPlan(sp.ranges, sp.bdims, kch, pj, nwc, sp.ow, sp.h,
                         sp.pw, d, sp.layout,
                         mxu_smem(plan.bdims, lo, hi, kch, pj, nwc * sp.ow,
                                  sp.h, d, 0 if sp.layout
                                  else len(plan.wdefs)))


def launch_mxu(x: torch.Tensor, table: torch.Tensor, plan: MxuPlan,
               sp: MxuStreamPlan | None) -> torch.Tensor:
    """K8 at ``sp``'s footprint (``None``: the planner's)."""
    return _launch(x, table, plan,
                   plan.stream() if sp is None
                   else mxu_footprint(plan, sp.kch, sp.pj, sp.nwc, sp.d))


def _launch(x: torch.Tensor, table: torch.Tensor, plan: MxuPlan,
            sp: MxuStreamPlan) -> torch.Tensor:
    """K8 at the footprint ``sp`` of ``plan``."""
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
    if sp.nstream > 2 ** 31 - 1:
        raise ValueError("kernel K8 takes at most 2^31 - 1 blocks")
    fold = plan.folded()
    coef = plan.coefficients()
    di = np.asarray(fold["di"], np.int32)
    dtup = np.asarray(fold["dtup"], np.int32)
    tbeg = np.cumsum([0] + [len(t) for t in fold["tuples"]]).astype(np.int32)
    tdj = np.asarray([dj for t in fold["tuples"] for dj, _w in t], np.int32)
    tw = np.asarray([w for t in fold["tuples"] for _dj, w in t], np.int32)
    out = torch.empty_like(x)
    # 16-byte pieces need 16-byte aligned storage (a view may start anywhere)
    pw = sp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_pencil_sweep_mxu(
        x.data_ptr(), out.data_ptr(), table.data_ptr(), GK, GJ, BK, BJ, BI,
        K0, K1, J0, J1, plan.klo, plan.khi, plan.jlo, plan.jhi, plan.ilo,
        plan.ihi, sp.kch, sp.pj, sp.nwc, sp.h, pw, sp.d, plan.rk(),
        len(plan.wdefs), coef.ctypes.data, len(di), di.ctypes.data,
        dtup.ctypes.data, len(fold["tuples"]), tbeg.ctypes.data,
        tdj.ctypes.data, tw.ctypes.data, sp.smem_bytes, sp.threads,
        _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_mxu")
    return out


pencil_sweep_mxu_kernel.launches = 0
pencil_sweep_mxu_kernel.layout_launches = 0


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
    args = trace.sweep_args("K8", 1, plan.ranges)

    def fn(flat_view: torch.Tensor) -> torch.Tensor:
        if tuple(flat_view.shape) != shape:
            raise ValueError(f"storage shape {tuple(flat_view.shape)} is not "
                             f"{shape}")
        dev = flat_view.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(plan.table).to(dev)
        with trace.span(trace.SWEEP, args):
            if dev.type == "cpu":
                return pencil_sweep_mxu_plain(flat_view, tables[dev], plan)
            return pencil_sweep_mxu_kernel(flat_view, tables[dev], plan)

    fn.plan = plan
    fn.n_wprofiles = len(wdefs)
    return fn
