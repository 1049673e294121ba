"""Two-level strong-scaling decomposition and its exchange on one device
(port of ``bricklib_tpu/comm/strong.py``; ref: strong/args.cpp:36-113,
strong/main.cpp:37-50, 191-320).

The global domain splits into fixed-size subdomains; a device holds a 3-D
block of them in Z-Morton order as one stack ``[nsub, nbricks, *bdims]``
that shares one :class:`BrickDecomp`.  The SHIFT exchange runs stage by
stage and sign by sign over the flat brick rows ``sub * nbricks + brick``:
links between subdomains of the stack are row-interval copies, and the
subdomains on a face of the block take their ghosts from the opposite
face (the periodic self-link of a one-device axis) through a receive
buffer gathered before the copies, as the reference gathers it with XLA
before its ``ppermute``.  Kernel K5 (``csrc/brick_copy.cu``) does each
(stage, sign) in one launch, in place.

The reference module imports ``jax.lax`` at its top, so the numpy planner
:class:`StrongDecomp` is ported here rather than imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..core import not_ported
from ..utils.zmort import zmort_ids
from .decomp import BrickDecomp
from .exchange import MULTI_GPU_ITEM, _merge_intervals, _row_vecs, check_stage


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
    """One (stage, sign) of the strong exchange over the flat rows:
    ``local_ivs`` copy ``flat[d0:d1] = flat[s0:s1]``; ``gather`` lists the
    face rows copied into the receive buffer before them, and
    ``recv_ivs`` scatter it: ``flat[d0:d1] = recv[r0:r1]``."""

    axis: int
    sign: int
    local_ivs: list
    gather: np.ndarray
    recv_ivs: list


def strong_stages(plan: StrongDecomp, axis_order=None) -> list[StrongStage]:
    """The strong SHIFT exchange as its non-empty (stage, sign) steps, in
    order (``exchange_strong_shift``,
    ``bricklib_tpu/comm/strong.py:376-418``).  A mesh axis with more than
    one device raises ``NotImplementedError``."""
    if any(m > 1 for m in plan.mesh_shape):
        raise not_ported(f"strong exchange over mesh {plan.mesh_shape}",
                         MULTI_GPU_ITEM)
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
            out.append(StrongStage(ax, sign, local_ivs, gather, recv_ivs))
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


def strong_exchange(plan: StrongDecomp, axis_order=None):
    """Plan the strong SHIFT exchange once; returns ``fn(batch) -> batch``
    that runs it in place on ``[nsub, nbricks, ...]`` storage: per
    non-empty (stage, sign), a gather of the face rows, then one K5
    launch.  Device tables are made on the first call on each device."""
    steps = strong_stages(plan, axis_order)
    nsub, nb = plan.nsub_local, plan.sdec.nbricks
    dev_tabs: dict = {}

    def fn(batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape[:2]) != (nsub, nb) or not batch.is_contiguous():
            raise ValueError(f"storage must be contiguous [{nsub}, {nb}, "
                             f"...], got {tuple(batch.shape)}")
        flat = batch.view((nsub * nb,) + tuple(batch.shape[2:]))
        dev = flat.device
        if dev not in dev_tabs:
            dev_tabs[dev] = [
                (torch.from_numpy(st.gather).to(dev),
                 stage_table(st.local_ivs, st.recv_ivs, flat)
                 if dev.type == "cuda" else None) for st in steps]
        for st, (gather, table) in zip(steps, dev_tabs[dev]):
            recv = flat.index_select(0, gather) if st.recv_ivs else None
            stage_copy(flat, st.local_ivs, recv, st.recv_ivs, table)
        return batch

    fn.stages = steps
    return fn


def exchange_strong_shift(batch: torch.Tensor, plan: StrongDecomp,
                          axis_order=None) -> torch.Tensor:
    """SHIFT exchange over the two-level decomposition, in place on the
    device's ``[nsub_local, nbricks, ...]`` stack, which is returned.  For
    a repeated step, build the plan once with :func:`strong_exchange`."""
    return strong_exchange(plan, axis_order)(batch)


def exchange_strong_remote(batch: torch.Tensor, plan: StrongDecomp,
                           axis_order=None) -> torch.Tensor:
    """The one-kernel remote-copy strong exchange.  On a mesh whose every
    axis has one device it has no remote copy and is the staged shift
    exchange, as in the reference (``strong.py:272-274``); a larger mesh
    raises ``NotImplementedError``."""
    return exchange_strong_shift(batch, plan, axis_order)
