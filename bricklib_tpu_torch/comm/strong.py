"""Two-level strong-scaling decomposition and its exchanges over a mesh of
ranks (port of ``bricklib_tpu/comm/strong.py``; ref: strong/args.cpp:36-113,
strong/main.cpp:37-50, 191-320).

The global domain splits into fixed-size subdomains; a rank holds a 3-D
block of them in Z-Morton order as one stack ``[nsub, nbricks, *bdims]``
that shares one :class:`BrickDecomp`, and a card the ``[p, nsub, nbricks,
*bdims]`` stack of its ranks (:mod:`.mesh`).  The SHIFT exchange runs
stage by stage and sign by sign over the flat brick rows ``sub * nbricks
+ brick``: links between subdomains of a rank are row-interval copies,
and the subdomains on a face of the block take their ghosts from the
opposite face of the source rank (itself on a one-rank axis) through a
receive buffer gathered before the copies, as the reference gathers it
with XLA before its ``ppermute``.  Kernel K5 (``csrc/brick_copy.cu``) does
each (stage, sign) in one launch per card, in place.  The remote form
(``exchange_strong_remote``) pushes the face rows straight into the
neighbour's ghost rows: per stage one launch per card of kernel K10
(``csrc/remote_copy.cu``).

The reference module imports ``jax.lax`` at its top, so the numpy planner
:class:`StrongDecomp` is ported here rather than imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.zmort import zmort_ids
from .decomp import BrickDecomp
from .exchange import (_merge_intervals, _row_vecs, _shift_perm, card_rows,
                       check_copies, check_stage, copy_rows_plain,
                       event_plan, launch_rows, mesh_fn, mesh_self_coords,
                       _one_rank_shape, on_card, run_ordered, shift_send_id,
                       written_rows)
from .mesh import Mesh


@dataclass
class StrongDecomp:
    """Plan: global domain -> device blocks of Morton-ordered subdomains.

    ``dom``: global domain in elements; ``sdom``: subdomain size;
    ``mesh_shape``: devices per axis; ``bdims``/``ghost_depth`` as in
    BrickDecomp (per subdomain).  Port of the reference's
    ``StrongDecomp`` (``bricklib_tpu/comm/strong.py:35-130``).
    """

    dom: tuple[int, ...]
    sdom: tuple[int, ...]
    mesh_shape: tuple[int, ...]
    bdims: tuple[int, ...]
    ghost_depth: tuple[int, ...]

    sdec: BrickDecomp | None = None
    local_block: tuple[int, ...] = ()
    sub_order: np.ndarray | None = None   # [nsub_local, ndim] block coords
    coord_to_row: np.ndarray | None = None

    def initialize(self, skinlist) -> "StrongDecomp":
        nd = len(self.dom)
        self.dom = tuple(int(x) for x in self.dom)
        self.sdom = tuple(int(x) for x in self.sdom)
        self.mesh_shape = tuple(int(x) for x in self.mesh_shape)
        sub_grid = []
        for a in range(nd):
            if self.dom[a] % self.sdom[a]:
                raise ValueError("dom must be a multiple of sdom")
            sub_grid.append(self.dom[a] // self.sdom[a])
        self.sub_grid = tuple(sub_grid)
        lb = []
        for a in range(nd):
            if self.sub_grid[a] % self.mesh_shape[a]:
                raise ValueError("subdomain grid must split over the mesh")
            lb.append(self.sub_grid[a] // self.mesh_shape[a])
        self.local_block = tuple(lb)

        self.sdec = BrickDecomp(dims=self.sdom,
                                ghost_depth=self.ghost_depth,
                                bdims=self.bdims).initialize(skinlist)

        # Morton order of the local block coords (ZMORT within a device,
        # ref: strong/args.cpp ZMORT subdomain indexing)
        ids = zmort_ids(self.local_block)
        coords = np.argsort(ids.ravel(), kind="stable")
        all_coords = np.array(list(np.ndindex(*self.local_block)),
                              dtype=np.int64)
        self.sub_order = all_coords[coords]
        c2r = np.zeros(self.local_block, dtype=np.int64)
        for row, c in enumerate(self.sub_order):
            c2r[tuple(c)] = row
        self.coord_to_row = c2r
        return self

    @property
    def nsub_local(self) -> int:
        return int(np.prod(self.local_block))

    def neighbor_rows(self, axis: int, sign: int):
        """For every local sub row: the batch row of its +-1 neighbor along
        ``axis``, and whether that neighbor is off the block (face sub).

        Returns (rows i64[nsub], is_remote bool[nsub], face_rows i64[nface],
        recv_order i64[nface]): ``face_rows`` are the rows this device
        sends (its subs on the opposite face), in the order that remote
        neighbors are consumed (``recv_order`` = local rows whose neighbor
        is remote).
        """
        L = self.local_block
        rows = np.zeros(self.nsub_local, dtype=np.int64)
        remote = np.zeros(self.nsub_local, dtype=bool)
        recv_order = []
        for row, c in enumerate(self.sub_order):
            nc = list(c)
            nc[axis] += sign
            if 0 <= nc[axis] < L[axis]:
                rows[row] = self.coord_to_row[tuple(nc)]
            else:
                remote[row] = True
                recv_order.append(row)
        send_rows = []
        for row in recv_order:
            c = list(self.sub_order[row])
            c[axis] = 0 if sign > 0 else L[axis] - 1
            send_rows.append(self.coord_to_row[tuple(c)])
        return (rows, remote, np.array(send_rows, dtype=np.int64),
                np.array(recv_order, dtype=np.int64))


@dataclass(frozen=True)
class StrongStage:
    """One (stage, sign) of the strong exchange over one rank's flat rows
    ``sub * nbricks + brick``: ``local_ivs`` copy ``flat[d0:d1] =
    flat[s0:s1]``; ``gather`` lists the face rows of the source rank (the
    rank itself on a one-rank axis) copied into the receive buffer before
    them, and ``recv_ivs`` scatter it: ``flat[d0:d1] = recv[r0:r1]``.
    ``ivs`` are the merged section intervals of one subdomain and
    ``send_rows``/``recv_rows`` the face subdomains that send and receive
    them (``StrongDecomp.neighbor_rows``)."""

    axis: int
    sign: int
    local_ivs: list
    gather: np.ndarray
    recv_ivs: list
    ivs: list
    send_rows: np.ndarray
    recv_rows: np.ndarray


def strong_stages(plan: StrongDecomp, axis_order=None) -> list[StrongStage]:
    """The strong SHIFT exchange as its non-empty (stage, sign) steps, in
    order (``exchange_strong_shift``,
    ``bricklib_tpu/comm/strong.py:376-418``); every rank has the same."""
    sdec = plan.sdec
    order, stages = sdec.stage_sections(axis_order)
    nb = sdec.nbricks
    out = []
    for s, ax in enumerate(order):
        for sign in (+1, -1):
            pairs = stages[s][sign]
            if not pairs:
                continue
            ivs = _merge_intervals(pairs)
            rows, remote, send_rows, recv_rows = plan.neighbor_rows(ax, sign)
            local_ivs = [(r * nb + d0, r * nb + d1, nr * nb + s0, nr * nb + s1)
                         for r, nr in enumerate(rows.tolist())
                         if not remote[r] for d0, d1, s0, s1 in ivs]
            src_idx = np.concatenate([np.arange(s0, s1)
                                      for _d0, _d1, s0, s1 in ivs])
            gather = (send_rows[:, None] * nb + src_idx[None, :]).ravel()
            recv_ivs = []
            for f, r in enumerate(recv_rows.tolist()):
                pos = f * len(src_idx)
                for d0, d1, _s0, _s1 in ivs:
                    recv_ivs.append((r * nb + d0, r * nb + d1, pos,
                                     pos + d1 - d0))
                    pos += d1 - d0
            if not (local_ivs or recv_ivs):
                continue
            check_stage([(d0, d1) for d0, d1, _, _ in local_ivs + recv_ivs],
                        [(s0, s1) for _, _, s0, s1 in local_ivs])
            out.append(StrongStage(ax, sign, local_ivs, gather, recv_ivs,
                                   ivs, send_rows, recv_rows))
    return out


def _source_ranks(mesh_shape, axis: int, sign: int) -> list[int]:
    """Per rank, the rank its ghosts along ``axis`` come from: one step
    along ``+sign``, periodic (the strong perm ``((r + sign) % m, r)``,
    ``bricklib_tpu/comm/strong.py:405-408``), itself on a one-rank axis."""
    src_of = dict((dst, src) for src, dst in
                  _shift_perm(mesh_shape[axis], sign))
    out = []
    for r in range(int(np.prod(mesh_shape))):
        c = list(np.unravel_index(r, mesh_shape))
        c[axis] = src_of[c[axis]]
        out.append(int(np.ravel_multi_index(tuple(c), mesh_shape)))
    return out


def stage_copy_plain(flat: torch.Tensor, local_ivs, recv, recv_ivs
                     ) -> torch.Tensor:
    """The plain PyTorch version of kernel K5: one (stage, sign), in
    place."""
    for d0, d1, s0, s1 in local_ivs:
        flat[d0:d1].copy_(flat[s0:s1])
    for d0, d1, r0, r1 in recv_ivs:
        flat[d0:d1].copy_(recv[r0:r1])
    return flat


def stage_table(local_ivs, recv_ivs, flat: torch.Tensor) -> torch.Tensor:
    """The device table kernel K5 reads for one (stage, sign): ``(dst,
    src, len, source)`` per interval in 16-byte vectors, source 0 for the
    storage and 1 for the receive buffer; int64, on the device of
    ``flat``."""
    rv = _row_vecs(flat)
    rows = [(d0 * rv, s0 * rv, (d1 - d0) * rv, k)
            for k, ivs in enumerate((local_ivs, recv_ivs))
            for d0, d1, s0, _s1 in ivs]
    return torch.tensor(rows, dtype=torch.int64).to(flat.device)


def stage_copy(flat: torch.Tensor, local_ivs, recv: torch.Tensor | None,
               recv_ivs, table: torch.Tensor | None = None) -> torch.Tensor:
    """One (stage, sign) of the strong exchange, in place on the flat rows
    ``[nsub * nbricks, ...]``: the interval copies ``local_ivs`` and the
    scatter of ``recv`` by ``recv_ivs``.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K5 once (``table``: the
    step's :func:`stage_table`, built here when not given)."""
    if not flat.is_contiguous():
        raise ValueError("exchange storage must be contiguous")
    n = flat.shape[0]
    nrecv = 0 if recv is None else recv.shape[0]
    for ivs, m in ((local_ivs, n), (recv_ivs, nrecv)):
        for d0, d1, s0, s1 in ivs:
            if not (0 <= d0 < d1 <= n and 0 <= s0 < s1 <= m
                    and d1 - d0 == s1 - s0):
                raise ValueError(f"interval ({d0}, {d1}, {s0}, {s1}) "
                                 f"invalid for {n} rows and {m} source rows")
    if recv_ivs and (recv is None or recv.shape[1:] != flat.shape[1:]
                     or recv.dtype != flat.dtype
                     or recv.device != flat.device
                     or not recv.is_contiguous()):
        raise ValueError("the receive buffer must be contiguous rows of the "
                         "storage's shape, type and device")
    if flat.device.type == "cpu":
        return stage_copy_plain(flat, local_ivs, recv, recv_ivs)
    if flat.device.type != "cuda":
        raise ValueError(f"kernel K5 runs on CUDA tensors, got {flat.device}")
    nivs = len(local_ivs) + len(recv_ivs)
    if nivs == 0:
        return flat
    if table is None:
        table = stage_table(local_ivs, recv_ivs, flat)
    if (table.device != flat.device or table.dtype != torch.int64
            or tuple(table.shape) != (nivs, 4)):
        raise ValueError("stage table must be int64 [n, 4] on the "
                         "storage's device")
    max_len = max(d1 - d0 for d0, d1, _, _ in local_ivs + recv_ivs)
    err = _build.library().bt_copy_stage(
        flat.data_ptr(), recv.data_ptr() if recv_ivs else flat.data_ptr(),
        table.data_ptr(), nivs, max_len * _row_vecs(flat),
        _build.stream_handle(flat.device))
    _build.check(err, "copy_stage")
    stage_copy.launches += 1
    return flat


stage_copy.launches = 0


def _card_steps(mesh: Mesh, steps, nsub: int, nb: int):
    """Per (stage, sign) and card, the batch of its ranks: ``(local_ivs,
    segments, recv_ivs)`` over the card's flat rows, ``segments`` listing
    ``(source card, gather index over its flat rows)`` in the order their
    rows make up the card's receive buffer."""
    rows = nsub * nb
    out = []
    for st in steps:
        src = _source_ranks(mesh.shape, st.axis, st.sign)
        per_card = []
        for c in range(len(mesh.cards)):
            ranks = mesh.ranks_on(c)
            local = [(s * rows + d0, s * rows + d1, s * rows + s0,
                      s * rows + s1)
                     for s in range(len(ranks))
                     for d0, d1, s0, s1 in st.local_ivs]
            segments, recv_ivs, pos = [], [], 0
            if st.recv_ivs:
                by_card: dict = {}
                for s, r in enumerate(ranks):
                    by_card.setdefault(mesh.place(src[r])[0], []).append(
                        (s, mesh.place(src[r])[1]))
                for g, pairs in by_card.items():
                    segments.append((g, np.concatenate(
                        [q * rows + st.gather for _s, q in pairs])))
                    for s, _q in pairs:
                        recv_ivs += [(s * rows + d0, s * rows + d1,
                                      pos + r0, pos + r1)
                                     for d0, d1, r0, r1 in st.recv_ivs]
                        pos += len(st.gather)
            per_card.append((local, segments, recv_ivs))
        out.append(per_card)
    return out


def strong_exchange(plan: StrongDecomp, axis_order=None, mesh=None):
    """Plan the strong SHIFT exchange once; returns ``fn(state) -> state``
    that runs it in place on each card's ``[p, nsub, nbricks, ...]``
    stack: per non-empty (stage, sign), every card's receive buffer
    gathered from the face rows of its ranks' source ranks
    (``index_select`` on the sender, then a copy to the receiving card:
    the reference's gather and ``ppermute``), then one K5 launch per card.
    ``mesh``: a :class:`~.mesh.Mesh` of ``plan.mesh_shape``; without one,
    ``plan.mesh_shape`` must have one rank and ``fn`` takes that rank's
    ``[nsub, nbricks, ...]`` stack.  Device tables are made on the first
    call."""
    steps = strong_stages(plan, axis_order)
    nsub, nb = plan.nsub_local, plan.sdec.nbricks

    def run(m, flats, tables):
        if "plan" not in tables:
            tables["plan"] = _card_steps(m, steps, nsub, nb)
        for s, per_card in enumerate(tables["plan"]):
            recvs = []
            for c, (_local, segments, _recv_ivs) in enumerate(per_card):
                parts = []
                for g, idx in segments:
                    key = ("gather", s, c, g)
                    if key not in tables:
                        tables[key] = torch.from_numpy(idx).to(
                            flats[g].device)
                    parts.append(flats[g].index_select(0, tables[key]).to(
                        flats[c].device))
                recvs.append(None if not parts else parts[0]
                             if len(parts) == 1 else torch.cat(parts))
            for c, (local, _segments, recv_ivs) in enumerate(per_card):
                with on_card(flats[c].device):
                    if (flats[c].device.type == "cuda"
                            and ("table", s, c) not in tables
                            and (local or recv_ivs)):
                        tables["table", s, c] = stage_table(local, recv_ivs,
                                                            flats[c])
                    stage_copy(flats[c], local, recvs[c], recv_ivs,
                               tables.get(("table", s, c)))

    m = _strong_mesh(plan, mesh)
    ranks = m.size if isinstance(m, Mesh) else 1
    fn = mesh_fn(run, m, (nsub, nb), 3, ghost_rows=written_rows(
        [(r, d0, d1) for r in range(ranks) for st in steps
         for d0, d1, *_ in st.local_ivs + st.recv_ivs]))
    fn.stages = steps
    return fn


def _strong_mesh(plan: StrongDecomp, mesh):
    if mesh is None:
        return plan.mesh_shape
    if tuple(mesh.shape) != tuple(plan.mesh_shape):
        raise ValueError(f"mesh {mesh.shape} is not the plan's "
                         f"{plan.mesh_shape}")
    return mesh


def exchange_strong_shift(batch, plan: StrongDecomp, axis_order=None,
                          mesh=None):
    """SHIFT exchange over the two-level decomposition, in place on the
    state (or, without ``mesh``, the one rank's ``[nsub_local, nbricks,
    ...]`` stack), which is returned.  For a repeated step, build the
    plan once with :func:`strong_exchange`."""
    return strong_exchange(plan, axis_order, mesh)(batch)


def strong_remote_copy(flats, card: int, rows, table=None):
    """Kernel K10 (``csrc/remote_copy.cu``), the port of the TPU kernel
    ``exchange_strong_remote``: one stage's copies that ``card`` issues,
    links between subdomains of a rank and face rows pushed into the
    neighbouring rank's ghost rows, in one launch on its current stream.
    ``flats``: every card's storage as flat brick rows; CPU storages take
    :func:`strong_remote_copy_plain`."""
    if launch_rows("bt_strong_remote_copy", flats, card, rows, table):
        strong_remote_copy.launches += 1
    return flats


strong_remote_copy.launches = 0


def strong_remote_copy_plain(flats, rows) -> None:
    """The plain PyTorch version of kernel K10: every row copied with
    ``Tensor.copy_``."""
    copy_rows_plain(flats, rows)


def strong_remote_stages(plan: StrongDecomp, axis_order=None) -> list:
    """The remote strong exchange's copies per stage (both signs at once,
    ``bricklib_tpu/comm/strong.py:237-271``): ``(dst_rank, d0, d1,
    src_rank, s0, s1)`` over the ranks' flat rows, every rank's links
    between its subdomains, and each rank's face rows pushed into the
    ghost rows of ``shift_send_id`` (itself on a one-rank axis)."""
    shape = tuple(plan.mesh_shape)
    nb = plan.sdec.nbricks
    out, axes = [], []
    for st in strong_stages(plan, axis_order):
        copies = []
        for q in range(int(np.prod(shape))):
            t = shift_send_id(*mesh_self_coords(shape, q), shape, st.axis,
                              st.sign)
            copies += [(q, d0, d1, q, s0, s1)
                       for d0, d1, s0, s1 in st.local_ivs]
            copies += [(t, int(rr) * nb + d0, int(rr) * nb + d1, q,
                        int(sr) * nb + s0, int(sr) * nb + s1)
                       for sr, rr in zip(st.send_rows, st.recv_rows)
                       for d0, d1, s0, s1 in st.ivs]
        if axes and axes[-1] == st.axis:
            out[-1] += copies
        else:
            out.append(copies)
            axes.append(st.axis)
    for copies in out:
        check_copies(copies)
    return out


def strong_remote_exchange(plan: StrongDecomp, mesh=None, axis_order=None):
    """Plan the strong exchange as remote copies once; returns ``fn(state)
    -> state``: per stage one K10 launch per card, stages ordered across
    cards by :func:`~.exchange.event_plan`.  Where no face crosses a rank
    boundary it is :func:`strong_exchange`, as in the reference
    (``strong.py:272-274``).  ``fn.plan`` (per stage and card, the K10
    rows) and ``fn.waits`` describe it."""
    shape = tuple(plan.mesh_shape)
    steps = strong_stages(plan, axis_order)
    if not any(shape[st.axis] > 1 and len(st.send_rows) for st in steps):
        return strong_exchange(plan, axis_order, mesh)
    mesh = _strong_mesh(plan, mesh)
    if not isinstance(mesh, Mesh):
        _one_rank_shape(shape)
    nsub, nb = plan.nsub_local, plan.sdec.nbricks
    sends = strong_remote_stages(plan, axis_order)
    kplan = [card_rows(mesh, copies, nsub * nb) for copies in sends]
    writes = [{r[0] for per_card in kplan for r in per_card[c]}
              for c in range(len(mesh.cards))]
    waits = event_plan(writes, len(kplan))

    def run(m, flats, tables):
        run_ordered(flats, kplan, strong_remote_copy, tables, waits)

    fn = mesh_fn(run, mesh, (nsub, nb), 3,
                 ghost_rows=written_rows([c for cs in sends for c in cs]))
    fn.stages, fn.plan, fn.waits = steps, kplan, waits
    return fn


def exchange_strong_remote(batch, plan: StrongDecomp, axis_order=None,
                           mesh=None):
    """The strong exchange as remote copies (K10), in place; the same
    result as :func:`exchange_strong_shift` bit for bit."""
    return strong_remote_exchange(plan, mesh, axis_order)(batch)
