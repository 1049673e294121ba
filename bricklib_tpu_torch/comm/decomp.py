"""BrickDecomp: the per-device layout planner.

Rebuilds the semantics of the reference's ``BrickDecomp<dim, BDims...>``
(include/brick-mpi.h:178-520) as a pure-numpy planning step producing
static tables a jitted exchange/stencil step consumes:

- the brick grid of one device is interior ∪ 26-direction *skin* (surface,
  ordered by ``skinlist``) ∪ *ghost*;
- ``initialize`` assigns storage indices region by region so every
  neighbor's ghost/skin set is contiguous (the pack-free exchange
  property), records ``sep_pos`` separators interior/surface/ghost
  (ref: brick-mpi.h:196,322-460) and the full adjacency
  (ref: _adj_populate, brick-mpi.h:266-296);
- ``sections`` is the (owner, skinlist-entry) granularity the multi-stage
  SHIFT exchange needs (ref: MultiStageExchangeView, brick-mpi.h:587-681);
  ``ghost``/``skin`` are the per-neighbor merged runs the PUT exchange
  sends as single messages (ref: exchange(), brick-mpi.h:466-495).

Storage index 0 stays the garbage brick: out-of-range adjacency points at
it, and planning starts at ``pos = align`` (ref: brick-mpi.h:357-366).

Axis conventions: shapes are numpy-ordered (axis 0 outermost); BitSet
direction tags are 1-based with tag 1 = innermost axis, so numpy axis
``a`` carries tag ``dims - a``.

Original: ``bricklib_tpu/comm/decomp.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.layout import BrickInfo, adjacency_from_grid
from ..utils.bitset import BitSet, allneighbors


@dataclass(frozen=True)
class Section:
    """One (owner, skinlist-entry) region: ``len`` bricks at ``pos``."""

    owner: BitSet       # empty = own skin; else the ghost's neighbor set
    skin_idx: int       # index into skinlist
    pos: int
    len: int


@dataclass(frozen=True)
class Run:
    """A contiguous per-neighbor storage run (merged consecutive
    sections), the unit of the PUT exchange."""

    neighbor: BitSet
    pos: int
    len: int
    skin_st: int        # first skinlist index in the run
    skin_ed: int        # one past the last


@dataclass
class BrickDecomp:
    """Plan the brick layout of one device's subdomain.

    Parameters mirror the reference constructor (brick-mpi.h:304-316):
    ``dims`` subdomain size in elements per numpy axis (excluding ghost),
    ``ghost_depth`` per-axis ghost depth in elements (a scalar applies to
    all axes; 0 disables exchange along that axis), ``bdims`` brick shape.
    """

    dims: tuple[int, ...]
    ghost_depth: tuple[int, ...]
    bdims: tuple[int, ...]
    numfield: int = 1
    align: int = 1

    # filled by initialize()
    skinlist: list[BitSet] = field(default_factory=list)
    grid: np.ndarray | None = None          # extended brick grid -> index
    info: BrickInfo | None = None
    sections: list[Section] = field(default_factory=list)
    ghost: list[Run] = field(default_factory=list)
    skin: list[Run] = field(default_factory=list)
    skin_size: list[int] = field(default_factory=list)
    sep_pos: tuple[int, int, int] | None = None
    nbricks: int = 0

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        nd = len(self.dims)
        if np.isscalar(self.ghost_depth):
            self.ghost_depth = (int(self.ghost_depth),) * nd
        self.ghost_depth = tuple(int(g) for g in self.ghost_depth)
        self.bdims = tuple(int(b) for b in self.bdims)
        for a in range(nd):
            if self.dims[a] % self.bdims[a]:
                raise ValueError("dims must be brick multiples")
            if self.ghost_depth[a] % self.bdims[a]:
                raise ValueError(
                    "ghost depth must be a brick multiple "
                    "(ref: brick-mpi.h:311-315)")
        # in bricks:
        self.gdims = tuple(d // b for d, b in zip(self.dims, self.bdims))
        self.gz = tuple(g // b for g, b in
                        zip(self.ghost_depth, self.bdims))
        for a in range(nd):
            if self.gdims[a] < 2 * self.gz[a]:
                raise ValueError("subdomain thinner than twice the ghost")

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def _tag_axis(self, tag: int) -> int:
        """BitSet tag (1-based, 1 = innermost) -> numpy axis."""
        return self.ndim - abs(tag)

    def _band(self, axis: int, region: BitSet) -> range:
        """Extended-coord brick range of ``region`` along ``axis``."""
        t = self.ndim - axis
        D, g = self.gdims[axis], self.gz[axis]
        if t in region:
            return range(D, D + g)
        if -t in region:
            return range(g, 2 * g)
        return range(2 * g, D)

    def _owner_shift(self, axis: int, owner: BitSet) -> int:
        t = self.ndim - axis
        D = self.gdims[axis]
        return D if t in owner else (-D if -t in owner else 0)

    def _region_cells(self, owner: BitSet, region: BitSet):
        """Row-major (outermost slowest) index tuple for the cells of
        (owner, region) in the extended grid — the iteration order of the
        reference's ``_populate`` (brick-mpi.h:225-247)."""
        idx = []
        for a in range(self.ndim):
            band = self._band(a, region)
            shift = self._owner_shift(a, owner)
            idx.append(np.array(band, dtype=np.int64) + shift)
        return np.ix_(*idx)

    def region_size(self, region: BitSet) -> int:
        n = 1
        for a in range(self.ndim):
            n *= len(self._band(a, region))
        return n

    # ------------------------------------------------------------------
    def initialize(self, skinlist: list[BitSet]):
        """Assign storage positions and build adjacency
        (ref: brick-mpi.h:322-460)."""
        nd = self.ndim
        self.skinlist = list(skinlist)
        tshape = tuple(D + 2 * g for D, g in zip(self.gdims, self.gz))
        grid = np.zeros(tshape, dtype=np.int32)
        assigned = np.zeros(tshape, dtype=bool)

        pos = self.align  # brick 0 (+ alignment pad) = garbage

        def mypop(owner: BitSet, region: BitSet) -> tuple[int, int]:
            nonlocal pos
            cells = self._region_cells(owner, region)
            n = self.region_size(region)
            block = np.arange(pos, pos + n, dtype=np.int32).reshape(
                tuple(len(ix.ravel()) for ix in cells))
            if assigned[cells].any():
                raise AssertionError("region overlap")
            grid[cells] = block
            assigned[cells] = True
            start = pos
            pos += n
            pos = -(-pos // self.align) * self.align
            return start, n

        # 1. inner interior
        mypop(BitSet(), BitSet())
        sep0 = pos

        # 2. skin, in skinlist order
        self.sections = []
        self.skin_size = []
        skin_pos: dict[int, tuple[int, int]] = {}
        for l, s in enumerate(self.skinlist):
            if not s:
                self.skin_size.append(0)
                continue
            if self.region_size(s) == 0:
                self.skin_size.append(0)
                continue
            st, n = mypop(BitSet(), s)
            skin_pos[l] = (st, n)
            self.sections.append(Section(BitSet(), l, st, n))
            self.skin_size.append(n)
        sep1 = pos

        # 3. ghost, grouped per neighbor in allneighbors order
        self.ghost = []
        self.skin = []
        for n_ in allneighbors(nd):
            if not n_:
                continue
            inv = ~n_
            run_l: list[int] = []
            run_pos = -1
            run_end = -1

            def flush():
                nonlocal run_l, run_pos, run_end
                if not run_l:
                    return
                # ghost run length from actual storage positions (end of
                # last section - run start), symmetric with the skin
                # side, so alignment padding mypop inserts between
                # sections is counted on both sides
                g_len = run_end - run_pos
                s_pos = skin_pos[run_l[0]][0]
                s_end = skin_pos[run_l[-1]][0] + skin_pos[run_l[-1]][1]
                if g_len != s_end - s_pos:
                    raise AssertionError(
                        "ghost/skin run length mismatch under align="
                        f"{self.align}; use align=1 or align-multiple "
                        "section sizes")
                self.ghost.append(Run(n_, run_pos, g_len,
                                      run_l[0], run_l[-1] + 1))
                self.skin.append(Run(inv, s_pos, s_end - s_pos,
                                     run_l[0], run_l[-1] + 1))
                run_l = []
                run_pos = -1
                run_end = -1

            for l, s in enumerate(self.skinlist):
                if s and inv <= s and self.region_size(s) > 0:
                    if run_l and l != run_l[-1] + 1:
                        flush()
                    if not run_l:
                        run_pos = pos
                    st, cnt = mypop(n_, s)
                    self.sections.append(Section(n_, l, st, cnt))
                    run_l.append(l)
                    run_end = st + cnt
                elif run_l:
                    flush()
            flush()
        sep2 = pos

        if not assigned.all():
            raise AssertionError("extended grid not fully covered")
        self.grid = grid
        self.sep_pos = (sep0, sep1, sep2)
        self.nbricks = pos
        adj = adjacency_from_grid(grid, nbricks=pos)
        self.info = BrickInfo(adj, nd)
        return self

    # ------------------------------------------------------------------
    def interior_grid(self) -> np.ndarray:
        """Grid restricted to owned (non-ghost) cells."""
        sl = tuple(slice(g, g + D) for g, D in zip(self.gz, self.gdims))
        return self.grid[sl]

    def owned_mask(self) -> np.ndarray:
        """Bool[nbricks]: True exactly for bricks this rank owns
        (interior + skin).  Derived from the grid table rather than a
        bare ``[1:sep_pos[1])`` slice, so the garbage brick 0 and any
        ``align > 1`` padding rows stay False."""
        m = np.zeros(self.nbricks, np.bool_)
        m[np.unique(self.interior_grid())] = True
        return m

    def periodic_grid(self, axes) -> np.ndarray:
        """Grid table with ghost cells along ``axes`` redirected to the
        periodically wrapped owned cells.

        On an undistributed axis no data needs to move at all: kernels
        reading through this table see the wrapped bricks directly —
        the TPU analog of the reference's same-rank zero-copy mmap links
        (strong/main.cpp:204-213).  Exchange then only handles the
        genuinely distributed axes."""
        g = self.grid.copy()
        for a in axes:
            D, gz = self.gdims[a], self.gz[a]
            if gz == 0:
                continue
            idx = np.arange(g.shape[a])
            wrapped = gz + (idx - gz) % D
            g = np.take(g, wrapped, axis=a)
        return g

    def neighbor_runs(self, neighbor: BitSet) -> tuple[list[Run], list[Run]]:
        g = [r for r in self.ghost if r.neighbor == neighbor]
        s = [r for r in self.skin if r.neighbor == ~neighbor]
        return g, s

    def stage_sections(self, axis_order: "list[int] | None" = None):
        """Section pairs for the multi-stage SHIFT exchange.

        Returns ``stages[s] = {+1: [(dst, src), ...], -1: [...]}`` for
        stage axis ``axis_order[s]`` (numpy axes; default innermost
        last like the reference's dimension loop, brick-mpi.h:594-681).
        ``dst`` is the receiver's ghost Section, ``src`` the matching
        sender Section (the sender's skin, or a ghost it received in an
        earlier stage — corner forwarding).
        """
        nd = self.ndim
        if axis_order is None:
            axis_order = list(range(nd - 1, -1, -1))  # innermost first
        stage_of = {ax: s for s, ax in enumerate(axis_order)}
        by_key = {(sec.owner.set, sec.skin_idx): sec
                  for sec in self.sections}
        stages = [{+1: [], -1: []} for _ in axis_order]
        for sec in self.sections:
            o = sec.owner
            if not o:
                continue
            axes = [self._tag_axis(t) for t in o]
            last = max(axes, key=lambda ax: stage_of[ax])
            s = stage_of[last]
            t = nd - last
            sign = +1 if t in o else -1
            src_owner = o.flip(sign * t)
            src = by_key[(src_owner.set, sec.skin_idx)]
            stages[s][sign].append((sec, src))
        return axis_order, stages
