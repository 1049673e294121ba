"""The PUT exchange fused into a pencil sweep on PyTorch (port of
``bricklib_tpu/codegen/fused_exchange.py``).

:func:`pencil_sweep_fusedx` has the meaning of the reference's
``pallas_pencil_sweep_fusedx``: every copy of a :func:`~..comm.exchange.
put_plan` (each rank's skin runs into its neighbours' ghost runs, the
input storage updated in place), then a ``fuse=1`` pencil sweep into a
fresh output, ghost-inclusive on the exchanged axes by default.  The
result equals :func:`~..comm.exchange.put_exchange` followed by the same
:func:`~.pencil_kernel.pencil_sweep`, bit for bit: the plain version
(:func:`fusedx_plain`) is exactly that composition, and kernel K11
(``csrc/fused_exchange.cu``) runs K1's k-streaming block body on the
blocks of the stream plan K1 itself runs for the card's ranks
(:meth:`~.pencil_kernel.SweepPlan.stream` of the batched sweep).

On a mesh, K11 is one launch per card and step carrying every rank the
card holds, one block per stream block (those that read no copied brick
first).  Every block first draws copy chunks from the card's pool until
it is empty; then each block that reads a copied brick waits until the
arrival counters of the gate groups it reads (per receiving rank:
``klo``, ``khi``, ``j``) reach their targets.
The host-side gating plan (:class:`CardPlan`, ``fn.cards``) is what the
tests read.  Across cards the launches are ordered by CUDA events
(:func:`~..comm.exchange.event_plan`).

A CPU state takes the plain version; a CUDA state launches K11 or raises.
The TPU-only knobs (``tile_j``, ``collective_id``, ``vmem_limit_bytes``,
``interpret``) are accepted and change nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _build, trace
from ..comm.exchange import (MAX_CARDS, _one_rank_shape, _wait, check_rows,
                             copy_rows_plain, event_plan, on_card,
                             put_plan_copies, written_rows)
from ..comm.mesh import Mesh, check_state, domain_axis_names
from ..core import not_ported
from .pencil_kernel import (FEATURES_ITEM, STREAM_THREADS, StreamPlan,
                            SweepPlan, _is_f32, pencil_sweep,
                            pencil_sweep_plain)
from .taps import as_ir

GROUPS = ("klo", "khi", "j")
# the most 16-byte vectors one K11 copy block moves (128 KiB)
CHUNK_VECS = 8192


@dataclass
class CardPlan:
    """What K11 runs on one card.  ``rows``: the copy chunks the card
    launches, ``(dst card, dst offset, src card, src offset, length,
    counter)`` in 16-byte vectors over the cards' flat storages, counter
    ``dst slot * 3 + group``; ``stream``: K1's stream plan of the batched
    ghost-inclusive sweep over the card's ranks; ``items``: its blocks in
    launch order (block ``w`` runs item ``w``), ``(slot, stream block of
    one rank, gate bits)`` (bit ``g`` of :data:`GROUPS`), the blocks that
    read no copied brick first;
    ``expect``: per counter of this card's ranks, the chunks that land
    there from every card."""

    rows: list
    stream: StreamPlan
    items: np.ndarray
    expect: np.ndarray


def _read_bricks(table: np.ndarray, plan: SweepPlan, kout: int, jout: int):
    """The table cells an output brick at (kout, jout) reads at level 0
    (fuse 1: its neighbours within the radius, clamped at the edges)."""
    BK, BJ, _BI = plan.bdims
    GK, GJ = table.shape
    kb = range((kout * BK - plan.lo[0]) // BK,
               (kout * BK + BK - 1 + plan.hi[0]) // BK + 1)
    jb = range((jout * BJ - plan.lo[1]) // BJ,
               (jout * BJ + BJ - 1 + plan.hi[1]) // BJ + 1)
    return {int(table[min(max(k, 0), GK - 1), min(max(j, 0), GJ - 1)])
            for k in kb for j in jb}


def gate_bits(plan: SweepPlan, put) -> np.ndarray:
    """Per output brick ``(k, j)`` of the sweep's ranges, the gate groups
    whose ghost rows it reads, as bits of :data:`GROUPS` (every rank
    receives every entry of the PUT plan ``put``)."""
    group_of = {}
    for _delta, d0, d1, _s0, _s1, _remote, group in put:
        for b in range(d0, d1):
            group_of[b] = GROUPS.index(group)
    (K0, K1), (J0, J1) = plan.ranges
    bits = np.zeros((K1 - K0, J1 - J0), np.int32)
    for k in range(K0, K1):
        for j in range(J0, J1):
            for b in _read_bricks(plan.table, plan, k, j):
                if b in group_of:
                    bits[k - K0, j - J0] |= 1 << group_of[b]
    return bits


def block_gates(sp: StreamPlan, bits: np.ndarray) -> np.ndarray:
    """Per stream block of one rank (the first ``sp.nchunk * sp.njg *
    sp.nit`` of :meth:`~.pencil_kernel.StreamPlan.blocks`), the union of
    the :func:`gate_bits` of the output bricks it writes: its chunk of
    brick rows, its pencils (its i tile reads whole pencils)."""
    (K0, _), (J0, _) = sp.ranges
    nper = sp.nchunk * sp.njg * sp.nit
    gates = np.zeros(nper, np.int32)
    for b, (_sub, (k0, k1), (j0, j1), _i, _e) in enumerate(
            sp.blocks()[:nper]):
        gates[b] = np.bitwise_or.reduce(
            bits[k0 - K0:k1 - K0, j0 - J0:j1 - J0], axis=None)
    return gates


def card_plans(mesh: Mesh, copies, plan: SweepPlan, bits: np.ndarray,
               nbricks: int, row_vecs: int) -> list[CardPlan]:
    """:class:`CardPlan` per card of ``mesh`` for ``copies`` (from
    :func:`~..comm.exchange.put_plan_copies`), the one-rank sweep ``plan``
    (fuse 1) and its :func:`gate_bits`."""
    ncards = len(mesh.cards)
    rows = [[] for _ in range(ncards)]
    expect = [np.zeros(3 * len(mesh.ranks_on(c)), np.int64)
              for c in range(ncards)]
    for r, d0, d1, q, s0, s1, group in copies:
        (c, slot), (cq, sq) = mesh.place(r), mesh.place(q)
        counter = 3 * slot + GROUPS.index(group)
        dst = (slot * nbricks + d0) * row_vecs
        src = (sq * nbricks + s0) * row_vecs
        n = (d1 - d0) * row_vecs
        for off in range(0, n, CHUNK_VECS):
            rows[cq].append((c, dst + off, cq, src + off,
                             min(CHUNK_VECS, n - off), counter))
            expect[c][counter] += 1
    out = []
    for c in range(ncards):
        p = len(mesh.ranks_on(c))
        sp = dataclasses.replace(plan, batch=p,
                                 batch_stride=nbricks).stream()
        gates = block_gates(sp, bits)
        items = np.asarray(
            [(s, b, g) for s in range(p) for b, g in enumerate(gates)],
            np.int32).reshape(-1, 3)
        order = np.argsort(items[:, 2] != 0, kind="stable")
        out.append(CardPlan(rows[c], sp, np.ascontiguousarray(items[order]),
                            expect[c]))
    return out


def brick_rows(mesh: Mesh, copies, nbricks: int) -> list[tuple]:
    """The copies as rows over the cards' flat storages, ``(dst card, dst
    row, src card, src row, nrows)`` in brick rows."""
    rows = []
    for r, d0, d1, q, s0, s1, _group in copies:
        (c, slot), (cq, sq) = mesh.place(r), mesh.place(q)
        rows.append((c, slot * nbricks + d0, cq, sq * nbricks + s0, d1 - d0))
    return rows


def fusedx_plain(flats, rows, plan: SweepPlan, tables,
                 nbricks: int) -> list[torch.Tensor]:
    """The plain PyTorch version of kernel K11: every copy of the PUT plan
    (``rows``, :func:`brick_rows`) into the cards' flat storages ``flats``
    in place, then :func:`~.pencil_kernel.pencil_sweep_plain` over each
    card's ranks; returns each card's fresh output (unwritten bricks
    undefined)."""
    copy_rows_plain(flats, rows)
    return [pencil_sweep_plain(x, tables[c], _batched(plan, x, nbricks))
            for c, x in enumerate(flats)]


def _batched(plan: SweepPlan, flat: torch.Tensor, nbricks: int) -> SweepPlan:
    p = flat.shape[0] // nbricks
    return dataclasses.replace(plan, batch=p, batch_stride=nbricks)


def pencil_sweep_fusedx_kernel(flats, card: int, outs, cp: CardPlan,
                               dev: dict, plan: SweepPlan, epoch: int,
                               nbricks: int) -> None:
    """Launch kernel K11 on card ``card``'s current stream: its copy
    chunks and its ranks' sweep into ``outs[card]``.  ``dev``: every
    card's device tables and counters (:func:`_device_tables`)."""
    if plan.taps is None:
        raise not_ported("a nonlinear stencil on a CUDA tensor",
                         FEATURES_ITEM)
    if len(plan.taps.coeffs) > 128:
        raise ValueError("kernel K11 takes at most 128 taps")
    x = flats[card]
    BK, BJ, BI = plan.bdims
    GK, GJ = plan.table.shape
    if x.dtype != torch.float32 or tuple(x.shape[1:]) != (BK, BJ, BI):
        raise ValueError(f"storage must be float32 [nb, {BK}, {BJ}, {BI}], "
                         f"got {x.dtype} {tuple(x.shape)}")
    sp = cp.stream
    (K0, K1), (J0, J1) = plan.ranges
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    offs = np.ascontiguousarray(plan.taps.offsets, np.int32)
    coeffs = np.ascontiguousarray(plan.taps.coeffs, np.float32)
    bases = (ctypes.c_void_p * len(flats))(*[t.data_ptr() for t in flats])
    ctrs = (ctypes.c_void_p * len(flats))(
        *[d["arrive"].data_ptr() for d in dev])
    d = dev[card]
    # 16-byte pieces need 16-byte aligned storage, as in K1
    pw = sp.pw if x.data_ptr() % 16 == 0 else 1
    err = _build.library().bt_fused_exchange(
        bases, ctrs, len(flats), card, d["rows"].data_ptr(), len(cp.rows),
        d["items"].data_ptr(), len(cp.items), d["expect"].data_ptr(),
        d["pool"].data_ptr(), epoch, outs[card].data_ptr(),
        d["table"].data_ptr(), GK, GJ, BK, BJ, BI, K0, K1, J0, J1, klo, khi,
        jlo, jhi, ilo, ihi, sp.batch, nbricks, sp.kch, sp.pj, sp.ti, sp.h,
        pw, sp.d, int(sp.edge_lo), int(sp.edge_hi), len(coeffs),
        offs.ctypes.data, coeffs.ctypes.data, sp.smem_bytes, STREAM_THREADS,
        _build.stream_handle(x.device))
    _build.check(err, "pencil_sweep_fusedx")
    pencil_sweep_fusedx_kernel.launches += 1


pencil_sweep_fusedx_kernel.launches = 0


def _device_tables(cards, flats, plan: SweepPlan) -> list[dict]:
    """Per card: its copy chunks, stream blocks, expected counts and grid
    table on the card, a zeroed counter of the chunks drawn from its pool
    and zeroed arrival counters (made once; the kernel never resets them,
    the epoch moves the targets)."""
    out = []
    for cp, x in zip(cards, flats):
        dv = x.device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dv)

        out.append({
            "rows": put(np.asarray(cp.rows, np.int64).reshape(-1, 6),
                        torch.int64),
            "items": put(cp.items, torch.int32),
            "expect": put(cp.expect, torch.int64),
            "table": put(plan.table, torch.int32),
            "pool": torch.zeros(1, dtype=torch.int64, device=dv),
            "arrive": torch.zeros(len(cp.expect), dtype=torch.int64,
                                  device=dv)})
    return out


def pencil_sweep_fusedx(stencil, grid: np.ndarray,
                        bdims: Sequence[int],
                        nbricks: int,
                        plan,
                        mesh_shape,
                        params: dict | None = None,
                        k_range: tuple[int, int] | None = None,
                        j_range: tuple[int, int] | None = None,
                        tile_j: int | None = None,
                        dtype=torch.float32,
                        compute_dtype=torch.float32,
                        interpret: bool | None = None,
                        collective_id: int = 2,
                        ghost_rings: tuple[int, int] | None = None,
                        vmem_limit_bytes: int = 110 * 2 ** 20,
                        mesh: Mesh | None = None):
    """Build ``fn(state) -> (out_state, state)``: the PUT exchange of
    ``plan`` (:func:`~..comm.exchange.put_plan`) in place on ``state``,
    then a ``fuse=1`` sweep of it into ``out_state``.  ``mesh_shape`` is
    the domain mesh the plan was made for; ``mesh`` places its ranks on
    cards (a :class:`~..comm.mesh.Mesh` of the same ranks in ravel order,
    the domain mesh or the flat one), and the state is one ``[p, nbricks,
    BK, BJ, BI]`` tensor per card.  Without ``mesh`` and on a mesh of one
    rank, ``fn(dat) -> (out, dat)`` takes one ``[nbricks, BK, BJ, BI]``
    tensor.

    ``k_range``/``j_range`` default to ghost-inclusive on the exchanged
    axes and owned-only on the table axes.  Arguments and errors follow
    ``pallas_pencil_sweep_fusedx``
    (``bricklib_tpu/codegen/fused_exchange.py:56``).  With a mesh,
    ``fn.mesh`` is it, ``fn.cards`` the gating plan per card and
    ``fn.waits`` the event plan; ``fn.copies`` are the plan's copies and
    ``fn.plan`` the one-rank sweep."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    ir = as_ir(stencil)
    if ir.dims != 3:
        raise NotImplementedError("fused-exchange sweep is 3-D pencil")
    if len(ir.sdef.inputs) != 1:
        raise NotImplementedError("pallas paths read one input grid")
    grid = np.asarray(grid)
    if grid.ndim == 3:
        if grid.shape[2] != 1:
            raise ValueError("pencil layout needs one brick per (k, j)")
        grid = grid[:, :, 0]
    GK, GJ = grid.shape
    k_ex = any(d[0][0] for d in plan)
    j_ex = any(d[0][1] for d in plan)
    if k_range is None:
        k_range = (0, GK) if k_ex else (1, GK - 1)
    if j_range is None:
        j_range = (0, GJ) if j_ex else (1, GJ - 1)
    K0, K1 = (int(k) for k in k_range)
    J0, J1 = (int(j) for j in j_range)
    BK, BJ, _BI = (int(b) for b in bdims)
    lo, hi = ir.radius()
    if lo[0] > BK or hi[0] > BK or lo[1] > BJ or hi[1] > BJ:
        raise ValueError("stencil radius exceeds brick dims")
    plan_rings = getattr(plan, "ghost_rings", None)
    if ghost_rings is None:
        ghost_rings = plan_rings if plan_rings is not None else (1, 1)
    elif (plan_rings is not None
            and tuple(int(g) for g in ghost_rings) != tuple(plan_rings)):
        raise ValueError(
            f"ghost_rings {tuple(ghost_rings)} contradicts the plan's "
            f"decomp ({tuple(plan_rings)}) — recv gates would race the "
            f"remote ghost copies")
    gzk, _gzj = (int(g) for g in ghost_rings)
    if gzk < 1 or _gzj < 1:
        raise ValueError("ghost_rings counts ghost-brick rings (>= 1)")
    if k_ex:
        # the reference's k-stream needs this depth; the port keeps its
        # refusal so that both packages take the same calls
        s = gzk + 1
        if (K1 - K0) - (s - K0) < 4 or GK - gzk <= s + 2:
            raise ValueError(f"fused-exchange sweep needs a deeper k "
                             f"grid (GK={GK}, ghost rings={gzk})")
        if (GK - gzk) - s - 2 < 1:
            raise ValueError("k grid too shallow for the khi gate")
    if tile_j is not None and (J1 - J0) % int(tile_j):
        raise ValueError(f"tile_j {int(tile_j)} must divide j extent "
                         f"{J1 - J0}")
    if not (_is_f32(dtype) and _is_f32(compute_dtype)):
        raise not_ported("storage or compute types other than float32",
                         FEATURES_ITEM)
    sweep = pencil_sweep(stencil, grid, bdims, nbricks, params,
                         k_range=(K0, K1), j_range=(J0, J1)).plan
    copies = put_plan_copies(plan, mesh_shape)
    bits = gate_bits(sweep, plan)
    nb = int(nbricks)
    if mesh is None:
        _one_rank_shape(mesh_shape)
    elif mesh.size != int(np.prod(mesh_shape)):
        raise ValueError(f"mesh {mesh.shape} places {mesh.size} ranks, the "
                         f"plan's mesh {mesh_shape} has "
                         f"{int(np.prod(mesh_shape))}")
    rank_shape = (nb,) + tuple(int(b) for b in bdims)
    built: dict = {}
    args = trace.sweep_args("K11", 1, sweep.ranges, exchange="fused")
    # the ghost bytes one call writes: the PUT copies' rows, f32 bricks
    nbytes = written_rows(copies) * 4 * int(np.prod(bdims))

    def plan_for(m: Mesh) -> dict:
        """The mesh's gating plan, event plan and rows, made once."""
        if m not in built:
            cards = card_plans(m, copies, sweep, bits, nb, _brick_vecs(bdims))
            built[m] = {"cards": cards, "rows": brick_rows(m, copies, nb),
                        "waits": event_plan([{r[0] for r in cp.rows}
                                             for cp in cards], 1),
                        "epoch": 0, "tables": None, "dev": None}
        return built[m]

    def run(m: Mesh, state):
        with trace.span(trace.SWEEP, args):
            trace.count("exchange_bytes", nbytes)
            return _run(m, state)

    def _run(m: Mesh, state):
        check_state(m, state, rank_shape)
        flats = [t.view((-1,) + rank_shape[1:]) for t in state]
        b = plan_for(m)
        if b["tables"] is None:
            check_rows(b["rows"], flats)
            b["tables"] = [torch.from_numpy(sweep.table).to(t.device)
                           for t in flats]
        types = {t.device.type for t in flats}
        if types == {"cpu"}:
            outs = fusedx_plain(flats, b["rows"], sweep, b["tables"], nb)
        elif types == {"cuda"}:
            if len(flats) > MAX_CARDS:
                raise ValueError(f"kernel K11 addresses at most {MAX_CARDS} "
                                 "cards")
            if b["dev"] is None:
                b["dev"] = _device_tables(b["cards"], flats, sweep)
            outs = [torch.empty_like(t) for t in flats]
            b["epoch"] += 1
            _wait(flats, b["waits"][0])
            for c, cp in enumerate(b["cards"]):
                with on_card(flats[c].device):
                    pencil_sweep_fusedx_kernel(flats, c, outs, cp, b["dev"],
                                               sweep, b["epoch"], nb)
            _wait(flats, b["waits"][1])
        else:
            raise ValueError(f"kernel K11 runs on CUDA tensors, got "
                             f"{[str(t.device) for t in flats]}")
        return [o.view(t.shape) for o, t in zip(outs, state)], state

    if mesh is None:
        meshes: dict = {}

        def fn(dat):
            if dat.device not in meshes:
                meshes[dat.device] = Mesh(
                    mesh_shape, domain_axis_names(len(mesh_shape)),
                    [dat.device])
            outs, _state = run(meshes[dat.device], [dat.unsqueeze(0)])
            return outs[0][0], dat
    else:
        def fn(state):
            return run(mesh, state)

        fn.mesh = mesh
        fn.cards = plan_for(mesh)["cards"]
        fn.waits = plan_for(mesh)["waits"]
    fn.plan = sweep
    fn.copies = copies
    return fn


def _brick_vecs(bdims) -> int:
    """16-byte vectors per f32 brick row of ``bdims``."""
    nbytes = 4 * int(np.prod(bdims))
    if nbytes % 16:
        raise ValueError(f"the copy kernels move 16-byte vectors; a brick "
                         f"row is {nbytes} bytes")
    return nbytes // 16
