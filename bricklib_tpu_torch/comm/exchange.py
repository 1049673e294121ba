"""Ghost exchanges over a mesh of ranks (port of
``bricklib_tpu/comm/exchange.py``).

- SHIFT multi-stage exchange (ref: MultiStageExchangeView semantics):
  stages run innermost axis first, and each moves the ghost sections whose
  last axis (in stage order) is the stage's axis, corners forwarded out of
  ghosts an earlier stage wrote.  A stage on a mesh axis of one rank is a
  periodic self-copy inside each rank's storage, done by kernel K2
  (``csrc/brick_copy.cu``): each run of such stages is one launch per
  card for all the card's ranks, its stages in order inside the launch
  (a chunk pool with gates between stages); on a distributed axis each
  (stage, sign) copies each
  rank's merged source intervals into the receiving rank's ghosts with
  ``Tensor.copy_``, the counterpart of ``lax.ppermute``.
- PUT exchange (ref: BrickDecomp::exchange, brick-mpi.h:466-495): one
  message per (ghost run, skin run) pair across ranks (``Tensor.copy_``),
  the self-copies of runs whose neighbour is the rank itself in one K2
  launch per card.
- The SHIFT exchange as remote copies (``exchange_shift_remote``): per
  stage, one launch per card of kernel K9 (``csrc/remote_copy.cu``)
  carrying the card's local copies and its ranks' pushes into their
  neighbours' ghosts, which may lie on another card; the stages are
  ordered across cards by CUDA events (:func:`event_plan`).
- The PUT plan of the fused sweep (:func:`put_plan`, :func:`put_send_ids`,
  numpy over rank ids): kernel K11 (``codegen/fused_exchange.py``) runs
  its copies inside the first sweep.

A mesh's state is one ``[p, nbricks, ...]`` tensor per card
(:mod:`.mesh`); every function here updates it in place and returns it.
Given a mesh shape whose every axis has one rank instead of a
:class:`~.mesh.Mesh`, the exchanges take one ``[nbricks, ...]`` tensor.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import math

import numpy as np
import torch

from .. import _build, trace
from .decomp import BrickDecomp
from .mesh import Mesh, check_state, domain_axis_names

# the most storages one K9 or K10 launch addresses (passed by value)
MAX_CARDS = 8


# --- mesh geometry (numpy over rank ids) -------------------------------

def _shift_perm(size: int, shift: int) -> list[tuple[int, int]]:
    """perm pairs (src, dst) so each dst receives from dst+shift
    (periodic)."""
    return [((r + shift) % size, r) for r in range(size)]


def _delta(neighbor, ndim: int) -> tuple[int, ...]:
    """Mesh-coordinate offset of the rank a ghost region copies from."""
    d = [0] * ndim
    for t in neighbor:
        d[ndim - abs(t)] = 1 if t > 0 else -1
    return tuple(d)


def neighbor_perm(neighbor, mesh_shape: tuple[int, ...]):
    """Linearized (src, dst) pairs for a diagonal neighbor direction, the
    analog of the reference's ``populate()`` rank map
    (brick-mpi.h:730-753)."""
    nd = len(mesh_shape)
    delta = _delta(neighbor, nd)
    pairs = []
    for c in np.ndindex(*mesh_shape):
        src = tuple((c[a] + delta[a]) % mesh_shape[a] for a in range(nd))
        pairs.append((int(np.ravel_multi_index(src, mesh_shape)),
                      int(np.ravel_multi_index(c, mesh_shape))))
    return pairs


def mesh_self_coords(mesh_shape: tuple[int, ...], rank: int):
    """``(lin, coords, strides)`` of ``rank`` over the mesh's row-major
    ravel order: the convention every remote-copy exchange shares."""
    nd = len(mesh_shape)
    strides = np.ones(nd, dtype=np.int64)
    for a in range(nd - 2, -1, -1):
        strides[a] = strides[a + 1] * mesh_shape[a + 1]
    coords = [int(c) for c in np.unravel_index(int(rank), mesh_shape)]
    return int(rank), coords, strides


def shift_send_id(lin, coords, strides, mesh_shape, ax: int, sign: int):
    """Rank a ``sign``-shift along mesh axis ``ax`` SENDS to (receiver r
    takes from r+sign, so sender q targets q-sign; cf. ``_shift_perm``),
    periodic."""
    tgt = (coords[ax] - sign + mesh_shape[ax]) % mesh_shape[ax]
    return int(lin + (tgt - coords[ax]) * int(strides[ax]))


# --- stage plans ---------------------------------------------------------

def _merge_intervals(pairs):
    """Merge (dst section, src section) pairs into maximal contiguous
    interval pairs ``[(d0, d1, s0, s1), ...]``."""
    ivs = sorted((d.pos, d.pos + d.len, s.pos, s.pos + s.len)
                 for d, s in pairs)
    out = []
    for d0, d1, s0, s1 in ivs:
        if out and out[-1][1] == d0 and out[-1][3] == s0:
            prev = out[-1]
            out[-1] = (prev[0], d1, prev[2], s1)
        else:
            out.append((d0, d1, s0, s1))
    return out


def check_stage(dsts, srcs) -> None:
    """Within one stage no destination row range may overlap another
    destination or any source range: the TPU issued a stage's copies
    concurrently, and so do the blocks of one K2, K5, K9 or K10 launch,
    for every rank of a card at once.  Ranges are ``(r0, r1)`` in one
    storage or ``(rank, r0, r1)``, keyed by rank."""
    def keyed(ranges):
        return sorted(r if len(r) == 3 else (0,) + tuple(r) for r in ranges)

    dst, src = keyed(dsts), keyed(srcs)
    for (ka, _a0, a1), (kb, b0, _b1) in zip(dst, dst[1:]):
        if ka == kb and b0 < a1:
            raise ValueError(f"stage destinations overlap: rank {ka} rows "
                             f"{_a0}:{a1} and {b0}:{_b1}")
    # sources may overlap each other: the furthest end among those that
    # start before a destination ends decides
    starts, ends = [], []
    for k, s0, s1 in src:
        starts.append((k, s0))
        ends.append(max(s1, ends[-1]) if ends and src[len(ends) - 1][0] == k
                    else s1)
    for k, d0, d1 in dst:
        i = bisect.bisect_left(starts, (k, d1)) - 1
        if i >= 0 and starts[i][0] == k and ends[i] > d0:
            raise ValueError(f"stage destination [{d0}, {d1}) of rank {k} "
                             f"overlaps a source")


class ShiftStage(list):
    """One stage of the SHIFT exchange: the list of its brick-row
    intervals ``(d0, d1, s0, s1)`` (``dat[d0:d1] = dat[s0:s1]``, both
    signs), with its mesh ``axis``, the intervals of each sign
    (``by_sign``) and whether the axis has more than one rank
    (``remote``)."""

    def __init__(self, axis: int, remote: bool):
        super().__init__()
        self.axis, self.remote = axis, remote
        self.by_sign: dict = {}


def shift_stages(decomp: BrickDecomp, mesh_shape, table_axes=(),
                 axis_order=None) -> list[ShiftStage]:
    """The SHIFT exchange as a list of stages (``exchange_shift`` and the
    plan of ``exchange_shift_remote``,
    ``bricklib_tpu/comm/exchange.py:193-257,317-331``).  Stages on
    ``table_axes`` are skipped, and so are sections with an owner
    component on a table axis: the sweep reads those directions through a
    ``periodic_grid`` table."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    order, stages = decomp.stage_sections(axis_order)
    table_axes = set(table_axes)

    def owner_axes(sec):
        return {decomp._tag_axis(t) for t in sec.owner}

    out = []
    for s, ax in enumerate(order):
        if ax in table_axes:
            continue
        st = ShiftStage(ax, mesh_shape[ax] > 1)
        for sign in (+1, -1):
            pairs = [(d, sr) for d, sr in stages[s][sign]
                     if not (owner_axes(d) & table_axes)]
            if pairs:
                st.by_sign[sign] = _merge_intervals(pairs)
                st.extend(st.by_sign[sign])
        if st:
            check_stage([(d0, d1) for d0, d1, _, _ in st],
                        [(s0, s1) for _, _, s0, s1 in st])
            out.append(st)
    return out


def stage_copies(stage: ShiftStage, mesh_shape) -> list[tuple]:
    """Every copy of one SHIFT stage over the mesh, ``(dst_rank, d0, d1,
    src_rank, s0, s1)``: each rank's ghosts take the rows of the rank one
    step along ``+sign`` (``_shift_perm``), itself on a one-rank axis."""
    mesh_shape = tuple(mesh_shape)
    n, m = int(np.prod(mesh_shape)), mesh_shape[stage.axis]
    out = []
    for sign, ivs in stage.by_sign.items():
        src_of = dict((dst, src) for src, dst in _shift_perm(m, sign))
        for r in range(n):
            c = list(np.unravel_index(r, mesh_shape))
            c[stage.axis] = src_of[c[stage.axis]]
            q = int(np.ravel_multi_index(tuple(c), mesh_shape))
            out.extend((r, d0, d1, q, s0, s1) for d0, d1, s0, s1 in ivs)
    check_copies(out)
    return out


def put_copies(decomp: BrickDecomp, mesh_shape, table_axes=()):
    """The PUT exchange over the mesh (``exchange_put``,
    ``bricklib_tpu/comm/exchange.py:99-135``): ``(dst_rank, d0, d1,
    src_rank, s0, s1, remote)`` per rank and (ghost run, skin run) pair,
    ``remote`` where the run's neighbour lies along a distributed axis.
    Runs with a component on a ``table_axes`` axis are skipped."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    table = set(table_axes)
    out = []
    for gr, sr in zip(decomp.ghost, decomp.skin):
        if table and ({decomp._tag_axis(t) for t in gr.neighbor} & table):
            continue
        delta = _delta(gr.neighbor, len(mesh_shape))
        remote = any(d and mesh_shape[a] > 1 for a, d in enumerate(delta))
        src_of = dict((dst, src) for src, dst in
                      neighbor_perm(gr.neighbor, mesh_shape))
        for r in range(int(np.prod(mesh_shape))):
            out.append((r, gr.pos, gr.pos + gr.len, src_of[r], sr.pos,
                        sr.pos + sr.len, remote))
    check_copies(out)
    return out


class PutPlan(list):
    """:func:`put_plan`'s entry list, carrying the decomposition's
    ghost-brick ring counts (``ghost_rings``), from which the fused sweep
    derives its gates instead of trusting a value given by its caller."""

    ghost_rings: tuple[int, ...] = (1, 1)


def put_plan(decomp: BrickDecomp, mesh_shape, table_axes=()) -> PutPlan:
    """The PUT exchange as the fused sweep runs it (``put_plan``,
    ``bricklib_tpu/comm/exchange.py:457-494``): one entry per (ghost run,
    skin run) pair whose direction lies on exchanged (non-table) axes,
    ``(delta, d0, d1, s0, s1, remote, group)``.  ``delta`` is the
    mesh-coordinate offset of the rank the ghost copies from, the rows are
    storage intervals, ``remote`` marks directions that cross ranks, and
    ``group`` names the gate the fused sweep waits on: ``"klo"``/``"khi"``
    for the pure-k faces, ``"j"`` for the j faces and every corner."""
    nd = decomp.ndim
    table = set(table_axes)
    plan = []
    for gr, sr in zip(decomp.ghost, decomp.skin):
        axes = {decomp._tag_axis(t) for t in gr.neighbor}
        if axes & table:
            continue
        delta = _delta(gr.neighbor, nd)
        remote = any(d and mesh_shape[a] > 1 for a, d in enumerate(delta))
        if axes == {0}:
            group = "klo" if -nd in gr.neighbor else "khi"
        else:
            group = "j"
        plan.append((delta, gr.pos, gr.pos + gr.len, sr.pos,
                     sr.pos + sr.len, remote, group))
    plan = PutPlan(plan)
    plan.ghost_rings = tuple(max(g, 1) for g in decomp.gz[:2])
    return plan


def put_send_ids(plan, mesh_shape, rank: int) -> list[int]:
    """The ranks ``rank`` sends to, one per remote entry of a
    :func:`put_plan` in plan order: the ghost at offset ``delta`` copies
    from the rank at ``+delta``, so ``rank`` sends to ``rank - delta``,
    periodic (``put_send_ids``, ``bricklib_tpu/comm/exchange.py:497-519``,
    as plain ints where the reference traces ``lax.axis_index``)."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    lin, coords, strides = mesh_self_coords(mesh_shape, rank)
    ids = []
    for delta, *_rest, remote, _group in plan:
        if not remote:
            continue
        tgt = lin
        for a, d in enumerate(delta):
            if d:
                ta = (coords[a] - d + mesh_shape[a]) % mesh_shape[a]
                tgt += (ta - coords[a]) * int(strides[a])
        ids.append(int(tgt))
    return ids


def put_plan_copies(plan, mesh_shape) -> list[tuple]:
    """Every copy of a :func:`put_plan` over the mesh as its senders send
    it: rank ``q`` copies its rows ``[s0, s1)`` into the ghost rows ``[d0,
    d1)`` of :func:`put_send_ids`' target (itself for an entry that does
    not cross ranks); ``(dst_rank, d0, d1, src_rank, s0, s1, group)``."""
    mesh_shape = tuple(int(m) for m in mesh_shape)
    out = []
    for q in range(int(np.prod(mesh_shape))):
        targets = iter(put_send_ids(plan, mesh_shape, q))
        for _delta, d0, d1, s0, s1, remote, group in plan:
            out.append((next(targets) if remote else q, d0, d1, q, s0, s1,
                        group))
    check_copies(out)
    return out


def check_copies(copies) -> None:
    """:func:`check_stage` over ``(dst_rank, d0, d1, src_rank, s0, s1,
    ...)`` copies: no destination of any rank overlaps another
    destination or any source."""
    check_stage([(c[0], c[1], c[2]) for c in copies],
                [(c[3], c[4], c[5]) for c in copies])


# --- K2: interval copies inside one storage ------------------------------

# threads of a K2 block (BT_POOL_THREADS in csrc/brick_copy.cu), and the
# most 16-byte vectors a chunk moves: one round of the block's loads
# (BT_POOL_DEEP a thread), 128 KiB
POOL_THREADS = 512
CHUNK_VECS = 16 * POOL_THREADS


def copy_intervals_plain(dat: torch.Tensor, ivs) -> torch.Tensor:
    """The plain PyTorch version of kernel K2 for one stage, in place."""
    for d0, d1, s0, s1 in ivs:
        dat[d0:d1].copy_(dat[s0:s1])
    return dat


def copy_stages_plain(dat: torch.Tensor, stage_ivs) -> torch.Tensor:
    """The plain PyTorch version of kernel K2: the stages one after
    another, in place."""
    for ivs in stage_ivs:
        copy_intervals_plain(dat, ivs)
    return dat


def _row_vecs(dat: torch.Tensor) -> int:
    """16-byte vectors per brick row of ``dat``; raises if a row is not a
    whole number of them."""
    row_bytes = dat[0].numel() * dat.element_size()
    if row_bytes % 16:
        raise ValueError(f"the copy kernels move 16-byte vectors; a brick "
                         f"row is {row_bytes} bytes")
    return row_bytes // 16


def check_intervals(stage_ivs, n: int) -> None:
    """Every interval of every stage must lie inside ``n`` brick rows and
    copy as many rows as it writes."""
    for ivs in stage_ivs:
        for d0, d1, s0, s1 in ivs:
            if not (0 <= d0 < d1 <= n and 0 <= s0 < s1 <= n
                    and d1 - d0 == s1 - s0):
                raise ValueError(f"interval ({d0}, {d1}, {s0}, {s1}) "
                                 f"invalid for {n} brick rows")


class PoolPlan:
    """Kernel K2's launch for one group of consecutive local stages on one
    storage: the stages' copies cut into chunks of one brick row, in stage
    order (``chunks``: ``(dst row, src row, stage, arrival counter or -1,
    gates)``; on the device a row longer than :data:`CHUNK_VECS` is cut
    again), the arrival counters (one per row a stage writes and a later
    stage reads: ``counters``, ``(stage, row)``) and the device tables;
    ``nrows`` and ``row_vecs`` describe the storage it was checked for;
    ``storage`` (its shape, type and device) is given where the plan is
    launched, which makes the device tables there."""

    def __init__(self, stage_ivs, nrows: int, row_vecs: int, storage=None,
                 nblocks: int | None = None):
        self.stage_ivs = [list(ivs) for ivs in stage_ivs]
        self.nrows, self.row_vecs = int(nrows), int(row_vecs)
        check_intervals(self.stage_ivs, self.nrows)
        # per stage the rows it writes and reads; a later stage may read
        # what an earlier one wrote (a gate), never write what it read or
        # wrote
        wrote: list[set] = []
        for s, ivs in enumerate(self.stage_ivs):
            check_stage([(d0, d1) for d0, d1, _, _ in ivs],
                        [(s0, s1) for _, _, s0, s1 in ivs])
            w = {r for d0, d1, _, _ in ivs for r in range(d0, d1)}
            for e in range(s):
                read = {r for _, _, s0, s1 in self.stage_ivs[e]
                        for r in range(s0, s1)}
                clash = w & (wrote[e] | read)
                if clash:
                    raise ValueError(
                        f"stage {s} writes row {min(clash)}, which stage {e} "
                        "of the same launch reads or writes")
            wrote.append(w)
        # the gates: per chunk the earlier stages that wrote its source row
        counter_of: dict = {}
        chunks = []
        for s, ivs in enumerate(self.stage_ivs):
            for d0, d1, s0, _s1 in ivs:
                for r in range(d1 - d0):
                    gates = tuple(counter_of.setdefault((e, s0 + r),
                                                        len(counter_of))
                                  for e in range(s) if s0 + r in wrote[e])
                    chunks.append((d0 + r, s0 + r, s, gates))
        self.counters = sorted(counter_of, key=counter_of.get)
        self.chunks = [(d, src, st, counter_of.get((st, d), -1), gates)
                       for d, src, st, gates in chunks]
        self.storage, self.nblocks = storage, nblocks
        if storage is not None:
            self._tables(storage[2])

    def _tables(self, dev) -> None:
        """The device tables (per chunk its records in 16-byte vectors: a
        brick row longer than :data:`CHUNK_VECS` is cut into ``pieces``,
        each drawn as a chunk of its own, and each adding to its row's
        arrival counter; the gate list) and the ticket and arrival
        counters, zero."""
        rv, recs, gates = self.row_vecs, [], []
        self.pieces = -(-rv // CHUNK_VECS)
        for dst, src, _s, counter, gs in self.chunks:
            for o in range(0, rv, CHUNK_VECS):
                recs.append((dst * rv + o, src * rv + o, min(CHUNK_VECS,
                                                             rv - o),
                             counter, len(gates), len(gates) + len(gs)))
            gates.extend(gs)
        self.chunk_table = torch.tensor(recs, dtype=torch.int64).to(dev)
        self.gate_table = torch.tensor(gates or [0], dtype=torch.int32).to(dev)
        self.state = torch.zeros(1 + len(self.counters), dtype=torch.int64,
                                 device=dev)
        self.nblocks = min(self.nblocks or len(recs), len(recs))

    def fits(self, dat: torch.Tensor) -> bool:
        """Whether the plan was checked for storage like ``dat``."""
        return (dat.shape, dat.dtype, dat.device) == self.storage


def pool_plan(stage_ivs, dat: torch.Tensor) -> PoolPlan:
    """Kernel K2's launch for ``stage_ivs`` on ``dat``, a CUDA tensor:
    checked once here (intervals inside the storage, no overlap within a
    stage, no later stage writing what an earlier one reads or writes),
    the device tables made on ``dat``'s card, one block per SM."""
    sms = torch.cuda.get_device_properties(dat.device).multi_processor_count
    return PoolPlan(stage_ivs, dat.shape[0], _row_vecs(dat),
                    (dat.shape, dat.dtype, dat.device), sms)


def copy_stages(dat: torch.Tensor, stage_ivs, plan: PoolPlan | None = None
                ) -> torch.Tensor:
    """Consecutive exchange stages, in place and in order: ``dat[d0:d1] =
    dat[s0:s1]`` for every interval of each stage, a stage reading what
    the earlier ones wrote.  A CPU tensor takes the plain version; a CUDA
    tensor launches kernel K2 once on the current stream (``plan``: the
    stages' :func:`pool_plan` for this storage, made here when not
    given).  ``copy_intervals.launches`` counts K2's launches."""
    if not dat.is_contiguous():
        raise ValueError("exchange storage must be contiguous")
    if dat.device.type == "cpu":
        check_intervals(stage_ivs, dat.shape[0])
        return copy_stages_plain(dat, stage_ivs)
    if dat.device.type != "cuda":
        raise ValueError(f"kernel K2 runs on CUDA tensors, got {dat.device}")
    if plan is None:
        plan = pool_plan(stage_ivs, dat)
    elif not plan.fits(dat):
        raise ValueError("the K2 plan was made for other storage")
    if not plan.chunks:
        return dat
    err = _build.library().bt_copy_pool(
        dat.data_ptr(), plan.chunk_table.data_ptr(),
        plan.chunk_table.shape[0], plan.gate_table.data_ptr(), plan.pieces,
        plan.state.data_ptr(), plan.nblocks, POOL_THREADS,
        _build.stream_handle(dat.device))
    _build.check(err, "copy_pool")
    copy_intervals.launches += 1
    return dat


def copy_intervals(dat: torch.Tensor, ivs, table: PoolPlan | None = None
                   ) -> torch.Tensor:
    """One exchange stage, in place: ``dat[d0:d1] = dat[s0:s1]`` for every
    interval; :func:`copy_stages` of the one stage (``table``: its
    :func:`pool_plan`, made here when not given)."""
    return copy_stages(dat, [ivs], table)


copy_intervals.launches = 0


# --- running an exchange over the cards of a mesh -------------------------

def _flat(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` with its ``lead`` leading (rank, subdomain, brick) axes as one
    axis of brick rows."""
    return t.view((-1,) + tuple(t.shape[lead:]))


def mesh_fn(run, mesh, rank_shape, lead: int = 2, *, ghost_rows: int):
    """``fn(state) -> state`` over a :class:`Mesh`, running ``run(mesh,
    flats, tables)`` on the state's flat brick rows in place (``tables``:
    a dict kept across calls for device tables).  Given a mesh shape whose
    every axis has one rank instead, ``fn(dat) -> dat`` over one tensor
    (the one-rank state on its device).  ``rank_shape``: the leading shape
    of one rank's storage, ``lead`` axes with the rank axis.

    Every exchange enters here: each call is a ``bricklib.exchange`` span
    and adds the ghost bytes it writes to the ``exchange_bytes`` counter
    (``ghost_rows``: the brick rows one call writes over every rank, each
    once, :func:`written_rows`; times the row size, reckoned on the first
    call)."""
    if isinstance(mesh, Mesh):
        tables: dict = {}
        nbytes = None

        def fn(state):
            nonlocal nbytes
            with trace.span(trace.EXCHANGE):
                check_state(mesh, state, rank_shape)
                flats = [_flat(t, lead) for t in state]
                if nbytes is None:
                    nbytes = ghost_rows * math.prod(
                        flats[0].shape[1:]) * flats[0].element_size()
                trace.count("exchange_bytes", nbytes)
                run(mesh, flats, tables)
            return state

        return fn
    shape = _one_rank_shape(mesh)
    per_dev: dict = {}

    def one(dat):
        if dat.device not in per_dev:
            per_dev[dat.device] = mesh_fn(
                run, Mesh(shape, domain_axis_names(len(shape)), [dat.device]),
                rank_shape, lead, ghost_rows=ghost_rows)
        per_dev[dat.device]([dat.unsqueeze(0)])
        return dat

    return one


def written_rows(copies) -> int:
    """The brick rows that ``copies`` (``(dst_rank, d0, d1, ...)``) write,
    each (rank, row) counted once."""
    by_rank: dict = {}
    for r, d0, d1, *_ in copies:
        by_rank.setdefault(r, []).append((d0, d1))
    n = 0
    for ivs in by_rank.values():
        end = 0
        for d0, d1 in sorted(ivs):
            if d1 > end:
                n += d1 - max(d0, end)
                end = d1
    return n


def _one_rank_shape(mesh_shape) -> tuple[int, ...]:
    shape = tuple(int(m) for m in mesh_shape)
    if any(m > 1 for m in shape):
        raise ValueError(f"mesh {shape} has more than one rank: pass a Mesh "
                         "(comm.mesh.make_domain_mesh) and its state")
    return shape


def card_intervals(mesh: Mesh, copies, rows: int) -> list[list[tuple]]:
    """Per card, the rank-local ``copies`` of its ranks as intervals over
    the card's flat rows (``rows`` brick rows per rank)."""
    out = [[] for _ in mesh.cards]
    for r, d0, d1, q, s0, s1, *_ in copies:
        if r != q:
            raise ValueError(f"copy from rank {q} into rank {r} is not local")
        c, slot = mesh.place(r)
        base = slot * rows
        out[c].append((base + d0, base + d1, base + s0, base + s1))
    return out


def copy_between_ranks(mesh: Mesh, flats, copies, rows: int) -> None:
    """The cross-rank ``copies`` as one ``Tensor.copy_`` each, from the
    source rank's rows into the destination rank's: the counterpart of
    ``lax.ppermute``, a plain transfer (peer to peer across cards)."""
    for r, d0, d1, q, s0, s1, *_ in copies:
        (c, slot), (cq, sq) = mesh.place(r), mesh.place(q)
        flats[c][slot * rows + d0:slot * rows + d1].copy_(
            flats[cq][sq * rows + s0:sq * rows + s1])
    trace.count("rank_copies", len(copies))


def _k2_per_card(flats, per_card, tables, key) -> None:
    """One K2 launch per card with copies (``per_card[c]``: its stages'
    intervals), its plan made on the first call."""
    for c, stage_ivs in enumerate(per_card):
        if not any(stage_ivs):
            continue
        with on_card(flats[c].device):
            plan = tables.get((key, c))
            if plan is None and flats[c].device.type == "cuda":
                plan = tables[key, c] = pool_plan(stage_ivs, flats[c])
            copy_stages(flats[c], stage_ivs, plan)


def stage_groups(stages) -> list[list[int]]:
    """The stages in launch order, each run of consecutive local stages
    one group (one K2 launch per card, the TPU kernel's ``flush_local``),
    each remote stage a group of its own."""
    groups: list[list[int]] = []
    for s, st in enumerate(stages):
        if st.remote or not groups or stages[groups[-1][0]].remote:
            groups.append([s])
        else:
            groups[-1].append(s)
    return groups


def shift_exchange(decomp: BrickDecomp, mesh, table_axes=(),
                   axis_order=None):
    """Plan the SHIFT exchange once; returns ``fn(state) -> state`` that
    runs it in place: each run of consecutive stages on one-rank axes as
    one K2 launch per card for all its ranks, each stage on a distributed
    axis as one ``Tensor.copy_`` per rank and interval (``exchange_shift``,
    ``bricklib_tpu/comm/exchange.py:193-257``).  Device tables are made on
    the first call, so a timed step copies nothing from the host.
    ``fn.stages``: the plan; ``fn.groups``: the stages of each launch."""
    shape = mesh.shape if isinstance(mesh, Mesh) else tuple(mesh)
    stages = shift_stages(decomp, shape, table_axes, axis_order)
    copies = [stage_copies(st, shape) for st in stages]
    groups = stage_groups(stages)
    nb = decomp.nbricks

    def run(m, flats, tables):
        for g, ss in enumerate(groups):
            if stages[ss[0]].remote:
                copy_between_ranks(m, flats, copies[ss[0]], nb)
                continue
            if ("ivs", g) not in tables:
                per = [card_intervals(m, copies[s], nb) for s in ss]
                tables["ivs", g] = [[p[c] for p in per]
                                    for c in range(len(m.cards))]
            _k2_per_card(flats, tables["ivs", g], tables, g)

    fn = mesh_fn(run, mesh, (nb,),
                 ghost_rows=written_rows([c for cs in copies for c in cs]))
    fn.stages, fn.groups = stages, groups
    return fn


def exchange_shift(state, decomp: BrickDecomp, mesh, table_axes=(),
                   axis_order=None):
    """Multi-stage SHIFT exchange over ``mesh`` (a :class:`Mesh`, with its
    state; or a mesh shape of one rank, with one ``[nbricks, ...]``
    tensor), in place, as ``input_output_aliases`` does on the TPU; the
    state is returned.  For a repeated step, build the plan once with
    :func:`shift_exchange`."""
    return shift_exchange(decomp, mesh, table_axes, axis_order)(state)


def put_exchange(decomp: BrickDecomp, mesh, table_axes=()):
    """Plan the PUT exchange once; returns ``fn(state) -> state``: the
    runs whose neighbour lies along a distributed axis as one
    ``Tensor.copy_`` per rank and run, then the self-copies of every rank
    of a card in one K2 launch (``exchange_put``,
    ``bricklib_tpu/comm/exchange.py:99-135``).  ``fn.copies``: the plan."""
    shape = mesh.shape if isinstance(mesh, Mesh) else tuple(mesh)
    copies = put_copies(decomp, shape, table_axes)
    remote = [c for c in copies if c[6]]
    local = [c for c in copies if not c[6]]
    nb = decomp.nbricks

    def run(m, flats, tables):
        copy_between_ranks(m, flats, remote, nb)
        if "ivs" not in tables:
            tables["ivs"] = [[ivs] for ivs in card_intervals(m, local, nb)]
        _k2_per_card(flats, tables["ivs"], tables, 0)

    fn = mesh_fn(run, mesh, (nb,), ghost_rows=written_rows(copies))
    fn.copies = copies
    return fn


def exchange_put(state, decomp: BrickDecomp, mesh, table_axes=()):
    """PUT exchange over ``mesh`` in place (see :func:`exchange_shift` for
    ``mesh`` and ``state``); the state is returned."""
    return put_exchange(decomp, mesh, table_axes)(state)


def on_card(dev):
    """The context that makes ``dev`` the current CUDA device (nothing for
    the CPU): a launch goes to the stream of its own card."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


# --- K9: the SHIFT exchange as remote copies ------------------------------

def send_copies(stage: ShiftStage, mesh_shape) -> list[tuple]:
    """Every copy of one SHIFT stage as its senders issue it (the plan of
    ``exchange_shift_remote``, ``bricklib_tpu/comm/exchange.py:349-384``):
    rank q pushes its rows into the ghosts of ``shift_send_id(q)``, itself
    on a one-rank axis; ``(dst_rank, d0, d1, src_rank, s0, s1)``."""
    mesh_shape = tuple(mesh_shape)
    out = []
    for sign, ivs in stage.by_sign.items():
        for q in range(int(np.prod(mesh_shape))):
            t = shift_send_id(*mesh_self_coords(mesh_shape, q), mesh_shape,
                              stage.axis, sign)
            out.extend((t, d0, d1, q, s0, s1) for d0, d1, s0, s1 in ivs)
    check_copies(out)
    return out


def card_rows(mesh: Mesh, copies, rows: int) -> list[list[tuple]]:
    """Per card, the rows of ``copies`` it issues, those whose source rank
    it holds: ``(dst_card, dst_row, src_card, src_row, nrows)`` over the
    cards' flat brick rows (``rows`` per rank)."""
    out = [[] for _ in mesh.cards]
    for r, d0, d1, q, s0, s1, *_ in copies:
        (c, slot), (cq, sq) = mesh.place(r), mesh.place(q)
        out[cq].append((c, slot * rows + d0, cq, sq * rows + s0, d1 - d0))
    return out


def event_plan(writes, nstages: int) -> list[list[tuple[int, int]]]:
    """Which card's stream waits on which around the stages of a
    remote-copy exchange: ``waits[s]`` (``s < nstages``) before stage
    ``s``, ``waits[nstages]`` after the last, each ``(waiter, waited)``.
    ``writes[c]``: the cards whose storage card ``c`` writes into.

    On entry each card waits on every card it writes into (a neighbour's
    sweep may still be writing there: the TPU kernel's barrier
    semaphore); between stages and after the last, every card waits on
    every other (corner forwarding reads what a peer wrote in the stage
    before, and the sweeps read the ghosts).  One card waits on nothing:
    its stream orders it."""
    n = len(writes)
    every = [(c, d) for c in range(n) for d in range(n) if c != d]
    entry = sorted((c, d) for c in range(n) for d in set(writes[c]) if d != c)
    return [entry] + [every] * nstages


def _wait(flats, pairs) -> None:
    """Make each waiter's current stream wait for the work queued so far on
    the streams of the cards it waits on (CUDA events)."""
    events = {}
    for d in sorted({d for _c, d in pairs}):
        events[d] = torch.cuda.Event()
        events[d].record(torch.cuda.current_stream(flats[d].device))
    for c, d in pairs:
        torch.cuda.current_stream(flats[c].device).wait_event(events[d])


def run_ordered(flats, plan, launch, tables, waits) -> None:
    """The stages of ``plan`` (``plan[s][c]``: the rows card ``c`` issues in
    stage ``s``), one ``launch(flats, c, rows, table)`` per card and
    stage, ordered across cards by ``waits`` (:func:`event_plan`)."""
    for s, per_card in enumerate(plan):
        _wait(flats, waits[s])
        for c, rows in enumerate(per_card):
            if not rows:
                continue
            with on_card(flats[c].device):
                if flats[c].device.type == "cuda" and (s, c) not in tables:
                    tables[s, c] = rows_table(rows, flats, c)
                launch(flats, c, rows, tables.get((s, c)))
    _wait(flats, waits[len(plan)])


def copy_rows_plain(flats, rows) -> None:
    """The plain PyTorch version of kernels K9 and K10:
    ``flats[dc][dr:dr+n] = flats[sc][sr:sr+n]`` for every row."""
    for dc, dr, sc, sr, n in rows:
        flats[dc][dr:dr + n].copy_(flats[sc][sr:sr + n])


def check_rows(rows, flats) -> None:
    """Every row ``(dst storage, dst row, src storage, src row, n)`` must
    lie inside its two storages."""
    for dc, dr, sc, sr, n in rows:
        if not (0 <= dc < len(flats) and 0 <= sc < len(flats) and n > 0
                and 0 <= dr and dr + n <= flats[dc].shape[0]
                and 0 <= sr and sr + n <= flats[sc].shape[0]):
            raise ValueError(f"row ({dc}, {dr}, {sc}, {sr}, {n}) invalid for "
                             f"storages of {[t.shape[0] for t in flats]} rows")


def rows_table(rows, flats, card: int) -> torch.Tensor:
    """The device table kernels K9 and K10 read, after :func:`check_rows`:
    per row ``(dst storage, dst offset, src storage, src offset,
    length)``, offsets and length in 16-byte vectors, int64, on the device
    of ``flats[card]``.  ``checked_for`` records the storages' row counts
    the rows were checked against."""
    check_rows(rows, flats)
    rv = _row_vecs(flats[0])
    table = torch.tensor([(dc, dr * rv, sc, sr * rv, n * rv)
                          for dc, dr, sc, sr, n in rows],
                         dtype=torch.int64).to(flats[card].device)
    table.checked_for = [t.shape[0] for t in flats]
    return table


def launch_rows(entry: str, flats, card: int, rows, table) -> bool:
    """Run ``rows``: the plain version where every storage lies on the CPU
    (the rows checked on every call; returns False), else one launch of
    the C entry point ``entry`` on ``flats[card]``'s current stream with
    every storage's base address passed by value (returns True).  The rows
    are checked again only where ``table`` was not made by
    :func:`rows_table` for storages of these sizes, so a repeated exchange
    spends no host time per row."""
    if not 1 <= len(flats) <= MAX_CARDS:
        raise ValueError(f"a remote-copy launch addresses 1 to {MAX_CARDS} "
                         f"storages, got {len(flats)}")
    for t in flats:
        if (not t.is_contiguous() or t.dtype != flats[0].dtype
                or t.shape[1:] != flats[0].shape[1:]):
            raise ValueError("storages must be contiguous brick rows of one "
                             "shape and type")
    types = {t.device.type for t in flats}
    if types == {"cpu"}:
        check_rows(rows, flats)
        copy_rows_plain(flats, rows)
        return False
    if types != {"cuda"}:
        raise ValueError(f"the remote-copy kernels run on CUDA tensors, got "
                         f"{[str(t.device) for t in flats]}")
    if not rows:
        return False
    if table is None:
        table = rows_table(rows, flats, card)
    elif getattr(table, "checked_for", None) != [t.shape[0] for t in flats]:
        check_rows(rows, flats)
    if (table.device != flats[card].device or table.dtype != torch.int64
            or tuple(table.shape) != (len(rows), 5)):
        raise ValueError("row table must be int64 [n, 5] on the launching "
                         "card")
    bases = (ctypes.c_void_p * len(flats))(*[t.data_ptr() for t in flats])
    max_len = max(n for *_r, n in rows) * _row_vecs(flats[0])
    err = getattr(_build.library(), entry)(
        bases, len(flats), table.data_ptr(), len(rows), max_len,
        _build.stream_handle(flats[card].device))
    _build.check(err, entry)
    return True


def remote_copy(flats, card: int, rows, table=None):
    """Kernel K9 (``csrc/remote_copy.cu``), the port of the TPU kernel
    ``exchange_shift_remote``: one stage's copies that ``card`` issues, in
    one launch on its current stream, each row from one storage into
    another, which may lie on another card.  ``flats``: every card's
    storage as flat brick rows; CPU storages take the plain version."""
    if launch_rows("bt_remote_copy", flats, card, rows, table):
        remote_copy.launches += 1
    return flats


remote_copy.launches = 0


def shift_remote_exchange(decomp: BrickDecomp, mesh, axis_order=None,
                          table_axes=()):
    """Plan the SHIFT exchange as remote copies once; returns ``fn(state)
    -> state``: per stage one K9 launch per card, carrying its local
    self-copies and its ranks' pushes into their neighbours' ghosts,
    stages ordered across cards by :func:`event_plan`.  Where no stage
    crosses a rank boundary it is :func:`shift_exchange`, as in the
    reference (``exchange.py:332-339``).  ``fn.stages``, ``fn.plan`` (per
    stage and card, the K9 rows) and ``fn.waits`` describe it."""
    shape = mesh.shape if isinstance(mesh, Mesh) else tuple(mesh)
    stages = shift_stages(decomp, shape, table_axes, axis_order)
    if not any(st.remote for st in stages):
        return shift_exchange(decomp, mesh, table_axes, axis_order)
    if not isinstance(mesh, Mesh):
        _one_rank_shape(shape)
    nb = decomp.nbricks
    sends = [send_copies(st, shape) for st in stages]
    plan = [card_rows(mesh, copies, nb) for copies in sends]
    writes = [{r[0] for per_card in plan for r in per_card[c]}
              for c in range(len(mesh.cards))]
    waits = event_plan(writes, len(plan))

    def run(m, flats, tables):
        run_ordered(flats, plan, remote_copy, tables, waits)

    fn = mesh_fn(run, mesh, (nb,),
                 ghost_rows=written_rows([c for cs in sends for c in cs]))
    fn.stages, fn.plan, fn.waits = stages, plan, waits
    return fn


def exchange_shift_remote(state, decomp: BrickDecomp, mesh, axis_order=None,
                          table_axes=()):
    """The SHIFT exchange as remote copies (K9), in place; the same result
    as :func:`exchange_shift` bit for bit."""
    return shift_remote_exchange(decomp, mesh, axis_order, table_axes)(state)
