"""High-level API on PyTorch: declare a stencil problem, step it, read it
back (port of ``bricklib_tpu/api.py``).

    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(16384, 16384), stencil=box9, st_iter=4)  # one card
    p.init(seed=0)                # or p.init(array=my_numpy_array)
    p.step(5)                     # 5 steps of st_iter iterations each
    out = p.result()              # dense numpy array (owned region)

The pencil backend runs rank 2 over kernel K6
(``codegen.pencil_kernel_2d``: single fields, aux fields and stencil
systems), ranks 3 and 4 over kernels K1 and K4 (single-field,
single-input stencils); ``backend="mxu"`` runs a single-field linear
3-D stencil over flat-pencil storage ``(nbricks, BK, BJ*BI)``, one
kernel K8 sweep (``codegen.mxu_kernel``) per iteration.
``backend="jnp"`` is the torch oracle (``codegen.jnp_backend``) at any
rank and on any mesh, with aux fields and systems: bricks a whole brick
deep in ghosts on every axis, i included, one SHIFT exchange of real
ghost bricks per step on every rank count (kernel K2 for the self-copies
of one-rank axes), then ``st_iter`` ghost-inclusive ``brick_apply``
iterations, the last over the owned bricks only.  ``"auto"`` picks it
where the reference does: rank 5 and above, ``mesh[-1] > 1``, and 2-D or
4-D bricks that do not span the row.

``dims`` are per rank, as in the reference.  On one rank every axis is
periodic through the grid table and nothing is exchanged.  On a mesh
(``mesh``, and ``slices`` stacked along the outermost axis: a mesh of
``eff_mesh`` ranks) the axes of one rank stay on the table and a step
is one SHIFT exchange (``comm.exchange.shift_exchange``) then
``st_iter / fuse`` sweeps, ghost-inclusive except the last: K1 and K4
batched over each card's ranks, K6 and K8 rank by rank.  With
``exchange="fused"`` (3-D pencil) the first sweep is kernel K11
(``codegen.fused_exchange``), which carries the PUT exchange, over a
flat mesh, and ``(st_iter - 1) / fuse`` sweeps follow.  ``devices``
places the ranks, one device per rank in ravel order, repeats allowed
(four ranks on one card: ``devices=["cuda:0"] * 4``); without it a mesh
takes one card per rank and raises where there are too few, and
``device`` (``cuda`` by default, raising where there is none) holds a
one-rank problem.  The tests pass ``device="cpu"``, which puts every rank
on the CPU and runs the kernels' plain versions.  The reference's other
options raise ``NotImplementedError`` naming the ROADMAP.md item that
brings them.

A caller that holds the state itself steps it with
``new = p.advance(state)``: exactly what ``step(1)`` runs, on the state
given (``p.state`` after ``init``), leaving the problem's own untouched.
With tracing on (``trace.tracing()``), the constructor runs inside a
``bricklib.plan`` span, with ``bricklib.plan.decomp`` (the
``BrickDecomp``) and ``bricklib.plan.kernels`` (the sweep planners)
inside it; ``init`` opens a ``bricklib.plan`` of its own around
``bricklib.plan.domain`` (the host draw, ``_stack_global`` and
``to_state``); every step runs inside a ``bricklib.step`` span whose
argument is the problem's count of steps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace
from .codegen.evaluate import resolve_const_from_params
from .codegen.jnp_backend import CardTables, oracle_iterate
from .codegen.ir import (PASS_FUSE_MAX, StencilIR, fold_linear,
                         generic_pass_estimate, vpu_pass_estimate)
from .codegen.fused_exchange import pencil_sweep_fusedx
from .codegen.mxu_kernel import pencil_sweep_mxu
from .codegen.pencil_kernel import FEATURES_ITEM, k1_launch, pencil_sweep
from .codegen.pencil_kernel_2d import pencil_sweep_2d
from .codegen.pencil_kernel_4d import k4_launch, pencil_sweep_4d
from .codegen.schedule import StepSweeps, outer_ranges
from .comm import BrickDecomp, skinlist_by_name
from .comm.exchange import on_card, put_plan, shift_exchange
from .comm.mesh import Mesh, make_domain_mesh, rank_views, to_state
from .convert import storage_from_reference
from .core import not_ported, random_array, require_device
from .core.setup import from_bricks, to_bricks
from .st.loader import StencilDef
from .stencils import bench_params, stencil_by_name

AUTODIFF_ITEM = "3-D autodiff"
RANKS_ITEM = "ranks 2/4 (autodiff)"
REST_ITEM = "the rest"


def _passes(sdef, params) -> "int | None":
    """Pass estimate for a linear stencil (None for a nonlinear one): the
    reference's auto-fuse gate, kept as it is so that both packages pick
    the same fuse."""
    lin = fold_linear(StencilIR.from_def(sdef),
                      resolve_const_from_params(params))
    return None if lin is None else vpu_pass_estimate(lin)


class Problem:
    def __init__(self, dims, stencil="mpi7pt", params=None,
                 bdims=None, ghost=None, mesh=(1, 1, 1),
                 backend="auto", dtype=np.float32, st_iter=1,
                 exchange="shift", field=None, slices=1,
                 schedule=None, device="cuda", devices=None):
        """Arguments as the reference's ``Problem`` (multi-input stencils
        take ``field`` and static aux fields; systems take a list of
        StencilDefs and ``field=(name1, ...)``; ``schedule`` takes
        ``fuse``, ``fuse_passes``, ``lookahead``, ``tile_j`` and
        ``vmem_limit_mb``, of which the last three are TPU knobs, accepted
        and ignored), plus ``device`` (a one-rank problem's device) and
        ``devices`` (one per rank of ``eff_mesh``, ravel order, repeats
        allowed).  Planned inside a ``bricklib.plan`` span."""
        self._steps = 0
        with trace.span(trace.PLAN):
            self._plan(dims, stencil, params, bdims, ghost, mesh, backend,
                       dtype, st_iter, exchange, field, slices, schedule,
                       device, devices)

    def _plan(self, dims, stencil, params, bdims, ghost, mesh, backend,
              dtype, st_iter, exchange, field, slices, schedule, device,
              devices):
        self.dims = tuple(int(d) for d in dims)
        nd = len(self.dims)
        mesh = tuple(int(m) for m in mesh)
        if nd != 3 and mesh == (1, 1, 1):
            mesh = (1,) * nd
        if len(mesh) != nd:
            raise ValueError(f"mesh needs one entry per domain axis "
                             f"({nd}), got {len(mesh)}")
        self.mesh_shape = mesh
        self.slices = int(slices)
        if self.slices < 1:
            raise ValueError("slices must be >= 1")
        self.eff_mesh = ((self.slices * self.mesh_shape[0],)
                         + self.mesh_shape[1:])
        self.schedule = dict(schedule or {})
        _sched_keys = {"fuse", "fuse_passes", "lookahead", "tile_j",
                       "vmem_limit_mb"}
        bad = set(self.schedule) - _sched_keys
        if bad:
            raise ValueError(f"unknown schedule keys {sorted(bad)}; "
                             f"valid: {sorted(_sched_keys)}")
        if isinstance(stencil, str):
            sdefs = [stencil_by_name(stencil)[0]]
        elif isinstance(stencil, StencilDef):
            sdefs = [stencil]
        elif isinstance(stencil, (list, tuple)):
            sdefs = list(stencil)
            if not sdefs or not all(isinstance(s, StencilDef)
                                    for s in sdefs):
                raise ValueError("a stencil system is a non-empty list "
                                 "of StencilDefs")
        else:
            raise TypeError(f"stencil: name, StencilDef or list, got "
                            f"{type(stencil)}")
        self.sdefs = sdefs
        self.sdef = sdefs[0]
        nfld = len(sdefs)
        self.nfld = nfld
        if field is None:
            if nfld > 1:
                raise ValueError("stencil systems need field=(name, "
                                 "...) naming each output's evolving "
                                 "input grid, in STENCIL order")
            fields = (next(iter(sdefs[0].inputs)),)
        else:
            fields = ((field,) if isinstance(field, str)
                      else tuple(field))
        if len(fields) != nfld:
            raise ValueError(f"{nfld} stencil output(s) need "
                             f"{nfld} field name(s), got {len(fields)}")
        if len(set(fields)) != nfld:
            raise ValueError("field names must be distinct")
        allinputs: dict = {}
        for s in sdefs:
            allinputs.update(s.inputs)
        for f_ in fields:
            if f_ not in allinputs:
                raise ValueError(f"field {f_!r} is not a stencil "
                                 f"input ({sorted(allinputs)})")
        for idx, (f_, s) in enumerate(zip(fields, sdefs)):
            if f_ not in s.inputs:
                raise ValueError(
                    f"field[{idx}] = {f_!r} is not an input of stencil "
                    f"output {idx} ({s.output.name} reads "
                    f"{list(s.inputs)}); field= must follow STENCIL "
                    f"order")
        self.fields = fields
        self.gname = fields[0]
        self.aux_names = [n for n in allinputs if n not in fields]
        self.params = bench_params(params)

        if backend == "auto":
            # the CUDA kernels take any row width (no TPU lane tiles); the
            # 2-D/4-D sweeps need one brick per outer cell
            row_ok = (nd == 3 or bdims is None
                      or int(bdims[-1]) == self.dims[-1])
            backend = ("pencil" if nd in (2, 3, 4)
                       and self.mesh_shape[-1] == 1 and row_ok else "jnp")
        if backend in ("pencil", "mxu") and self.mesh_shape[-1] != 1:
            raise ValueError(
                "pencil backend needs the innermost axis undistributed "
                "(mesh[-1] == 1); use backend='jnp' instead")
        if backend == "pencil" and nd not in (2, 3, 4):
            raise ValueError("pencil backend is 2-D/3-D/4-D; use "
                             "backend='jnp' for other ranks")
        if backend not in ("pencil", "mxu", "jnp"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        if self.schedule and backend != "pencil":
            raise ValueError(f"schedule= tunes the pencil backends; "
                             f"backend is {backend!r}")
        if backend == "mxu":
            # flat-pencil sweep (codegen.mxu_kernel): single linear
            # evolving field, 3-D, fuse=1, shift exchange
            if nd != 3 or nfld != 1 or self.aux_names:
                raise ValueError("backend='mxu' runs single-field "
                                 "single-input 3-D stencils")
            if exchange != "shift":
                raise ValueError("backend='mxu' uses exchange='shift'")
        if bdims is None and backend == "jnp":
            bdims = tuple(min(8, d) for d in self.dims[:-1]) + (
                min(128, self.dims[-1]),)
        elif bdims is None:
            by2 = (32 if nd == 2 and self.dims[0] % 32 == 0
                   and self.dims[0] >= 128 else 8)
            bdims = ((by2, self.dims[1]) if nd == 2
                     else (8, 8, self.dims[2]) if nd == 3
                     else (2, 8, 8, self.dims[3]))
        self.bdims = tuple(int(b) for b in bdims)
        if ghost is None:
            # the oracle's ghost is a whole brick on every axis, i included
            ghost = (self.bdims if backend == "jnp"
                     else self.bdims[:-1] + (0,))
        self.ghost = tuple(int(g) for g in ghost)

        if exchange not in ("shift", "fused"):
            raise ValueError("exchange is 'shift' or 'fused'")
        if exchange == "fused" and backend != "pencil":
            raise ValueError("exchange='fused' runs on the pencil "
                             "backend")
        if exchange == "fused" and (self.aux_names or nfld > 1):
            raise ValueError("exchange='fused' supports single-field, "
                             "single-input stencils; use "
                             "exchange='shift'")
        if exchange == "fused" and nd != 3:
            raise ValueError("exchange='fused' is 3-D pencil only")
        self.exchange = exchange
        if np.dtype(dtype) != np.float32:
            raise not_ported(f"dtype {np.dtype(dtype).name}", FEATURES_ITEM)
        self.dtype = np.dtype(dtype)
        if (backend == "pencil" and nd in (3, 4)
                and (nfld > 1 or self.aux_names)):
            raise not_ported(f"aux fields and stencil systems on rank {nd}",
                             FEATURES_ITEM)
        with trace.span(trace.PLAN_DECOMP):
            self.dec = BrickDecomp(dims=self.dims, ghost_depth=self.ghost,
                                   bdims=self.bdims).initialize(
                skinlist_by_name("good", nd))
        if self.slices > 1 and exchange == "fused":
            raise ValueError(
                "exchange='fused' issues kernel remote DMAs, an "
                "ICI-only transport; multi-slice meshes use "
                "exchange='shift' (cross-slice stages lower to "
                "DCN collective-permutes)")

        self.st_iter = int(st_iter)
        rad = max(max(max(lo_r), max(hi_r))
                  for lo_r, hi_r in (s.radius() for s in sdefs))
        dec, msh, bd = self.dec, self.eff_mesh, self.bdims
        nb = dec.nbricks
        self._states = None
        self._aux_states = ()
        if backend == "jnp":
            self._make_mesh(device, devices, flat=False)
            self._oracle(rad)
            return
        _sch = self.schedule
        _sch_fuse = _sch.get("fuse")
        _sch_fuse = None if _sch_fuse is None else int(_sch_fuse)
        _pass_max_user = _sch.get("fuse_passes")
        pass_max = (PASS_FUSE_MAX if _pass_max_user is None
                    else int(_pass_max_user))

        def _fit_fuse(req, budget, halo_ok):
            if budget % req or not budget or not halo_ok(req):
                raise ValueError(
                    f"schedule fuse={req} must divide the sweep "
                    f"budget ({budget}) and fit the halo "
                    f"(fuse*radius within the brick/ghost depth)")
            return req

        # axes of one rank are periodic through the grid table; the others
        # exchange real ghost bricks before every step
        table_axes = tuple(a for a in range(nd) if msh[a] == 1)
        distributed = len(table_axes) < nd
        gmin = min(bd[:-1])
        if distributed and self.st_iter * rad > gmin:
            raise ValueError(
                f"st_iter {self.st_iter} x radius {rad} exceeds "
                f"ghost depth {gmin}")
        kgrid = dec.periodic_grid(table_axes)
        fused_x = exchange == "fused" and distributed
        per_card = False
        if backend == "mxu":
            # fuse=1: the factorized form is the amortization
            fuse = 1

            def make(p, ghost):
                return pencil_sweep_mxu(
                    self.sdef, kgrid, bd, nb, self.params,
                    **outer_ranges(kgrid, table_axes, ghost))

            sweeps = StepSweeps(make, self.st_iter, distributed)
            kern = sweeps.pair(1)[0]
            plan = kern.plan
            info = {"kernel": "K8 pencil_sweep_mxu",
                    "w_profiles": kern.n_wprofiles,
                    "taps": [plan.n_ktaps()]}
            sp = plan.stream()
            info["tile_i"], info["smem_bytes"] = sp.ti, sp.smem_bytes
        elif nd == 2:
            fuse = 1
            if _sch_fuse is not None:
                if _sch_fuse > 1 and (nfld > 1 or self.aux_names):
                    raise ValueError("2-D fusion is single-field "
                                     "single-input only")
                fuse = _fit_fuse(_sch_fuse, self.st_iter,
                                 lambda c: c * rad <= bd[0])
            elif nfld == 1 and not self.aux_names:
                np_ = _passes(sdefs[0], self.params)
                if np_ is None:
                    np_ = generic_pass_estimate(sdefs[0])
                if np_ is not None and np_ <= pass_max:
                    for cand in (4, 2):
                        if (self.st_iter % cand == 0 and self.st_iter
                                and cand * rad <= bd[0]):
                            fuse = cand
                            break
            sd_or_sys = sdefs if nfld > 1 else self.sdef

            def make(p, ghost):
                return pencil_sweep_2d(
                    sd_or_sys, kgrid, bd, nb, self.params, fuse=fuse,
                    **outer_ranges(kgrid, table_axes, ghost))

            sweeps = StepSweeps(make, self.st_iter // fuse, distributed)
            kern = sweeps.pair(1)[0]
            plan = kern.plan
            info = {"kernel": "K6 pencil_sweep_2d",
                    "taps": (None if plan.taps is None
                             else [len(t) for t in plan.taps])}
            if plan.taps is not None:
                sp = plan.stream()
                info["tile_x"], info["smem_bytes"] = sp.tx, sp.smem_bytes
        else:
            # the fused exchange runs its own first sweep at fuse=1, so
            # it fuses only the remaining st_iter - 1 iterations
            budget = self.st_iter - 1 if fused_x else self.st_iter
            fuse = 1
            if _sch_fuse is not None:
                fuse = _fit_fuse(
                    _sch_fuse, budget,
                    lambda c: all(c * rad <= b for b in bd[:-1]))
            else:
                np_ = _passes(sdefs[0], self.params)
                if np_ is None:
                    np_ = generic_pass_estimate(sdefs[0])
                top = 4 if nd == 3 else 2
                cands = (4, 2) if np_ <= pass_max else ()
                for cand in (c for c in cands if c <= top):
                    if (budget % cand == 0 and budget
                            and all(cand * rad <= b for b in bd[:-1])):
                        fuse = cand
                        break
            sweep = pencil_sweep if nd == 3 else pencil_sweep_4d

            def make(p, ghost):
                return sweep(self.sdef, kgrid, bd, p * nb, self.params,
                             **outer_ranges(kgrid, table_axes, ghost),
                             fuse=fuse, batch=p, batch_stride=nb)

            sweeps = StepSweeps(make, budget // fuse, distributed)
            per_card = True
            kern = sweeps.pair(1)[0]
            plan = kern.plan
            info = {"kernel": ("K1 pencil_sweep" if nd == 3
                               else "K4 pencil_sweep_4d"),
                    "taps": (None if plan.taps is None
                             else [len(plan.taps.coeffs)])}
            if plan.taps is not None:
                sp = (k1_launch if nd == 3 else k4_launch)(plan)
                info["body"] = sp.body
                info["tile_i"], info["smem_bytes"] = sp.ti, sp.smem_bytes
        self.fuse = fuse
        self._make_mesh(device, devices, flat=fused_x)
        exchange_fn = fusedx = None
        if fused_x:
            fusedx = pencil_sweep_fusedx(
                self.sdef, kgrid, bd, nb, put_plan(dec, msh, table_axes),
                msh, self.params, mesh=self.mesh,
                **outer_ranges(kgrid, table_axes, self.st_iter > 1))
            info["fused_kernel"] = "K11 pencil_sweep_fusedx"
        elif distributed:
            exchange_fn = shift_exchange(dec, self.mesh,
                                         table_axes=table_axes)
        cards = self.mesh.cards

        def by_rank(k, states):
            """``k`` on every rank's views of ``states`` (per field, in
            ``k``'s field order); per output, the new state (a copy per
            card stacks several ranks' outputs)."""
            outs = None
            for c, dev in enumerate(cards):
                with on_card(dev):
                    res = [k(*(st[c][s] for st in states))
                           for s in range(states[0][c].shape[0])]
                res = [r if isinstance(r, tuple) else (r,) for r in res]
                if outs is None:
                    outs = [[] for _ in res[0]]
                for o, per in enumerate(outs):
                    per.append(res[0][o].unsqueeze(0) if len(res) == 1
                               else torch.stack([r[o] for r in res]))
            return outs

        def one(states, auxv):
            states = list(states)
            if fusedx is not None:
                states = [fusedx(states[0])[0]]
            elif exchange_fn is not None:
                for st in states:
                    exchange_fn(st)
            if per_card:
                return [sweeps(states[0])]
            # K6 and K8 rank by rank
            vs = dict(zip(self.aux_names, auxv))
            for k in sweeps.order(1):
                vs.update(zip(self.fields, states))
                names = k.fields if hasattr(k, "fields") else self.fields[:1]
                states = by_rank(k, [vs[n_] for n_ in names])
            return states

        self._one = one
        self._exec_plan = {
            "backend": backend, "fuse": fuse,
            "exchange": ("fused" if fusedx is not None
                         else exchange if distributed else "table"),
            "table_axes": list(table_axes), "kernels": [info],
        }

    def _make_mesh(self, device, devices, flat: bool) -> None:
        """Place the ranks of ``eff_mesh``: ``devices``, one per rank, or
        ``device`` for a one-rank problem (and every rank of a CPU one).
        ``flat``: one flat axis of ranks, placement-identical to the
        domain mesh (the fused exchange addresses ranks by linear id)."""
        n = self._ndev
        if devices is None:
            self.device = require_device(device)
            if self.device.type == "cpu" or n == 1:
                devices = [self.device] * n
        dmesh = make_domain_mesh(self.eff_mesh, devices=devices)
        self.device = dmesh.devices[0]
        self.mesh = Mesh((n,), ("dev",), dmesh.devices) if flat else dmesh

    def _oracle(self, rad: int) -> None:
        """The torch oracle's step (reference ``api.py:636-682``): one
        SHIFT exchange over every axis, then ``st_iter`` ghost-inclusive
        ``brick_apply`` iterations, the last over the owned bricks only
        (the others keep their exchanged or computed values).  The ranks
        of a card run as one ``brick_apply`` over their stacked storage,
        the adjacency of rank ``s`` offset by ``s * nbricks`` (each rank's
        off-grid reads hit its own brick 0), uploaded once per card."""
        if (self.st_iter > 1
                and self.st_iter * rad > min(
                    (g for g in self.ghost if g), default=0)):
            raise ValueError("st_iter x radius exceeds ghost depth")
        dec, bd, nb = self.dec, self.bdims, self.dec.nbricks
        exchange_fn = shift_exchange(dec, self.mesh)
        tables = CardTables(nb, adj=dec.info.adj,
                            owned=np.arange(1, dec.sep_pos[1]))

        def one(states, auxv):
            for st in states:
                exchange_fn(st)
            out = [[] for _ in states]
            for c, t0 in enumerate(states[0]):
                tb = tables(t0.device, t0.shape[0])
                avs = {n_: a[c].view((-1,) + bd)
                       for n_, a in zip(self.aux_names, auxv)}
                with on_card(t0.device):
                    views = oracle_iterate(
                        self.sdefs, self.fields,
                        [st[c].view((-1,) + bd) for st in states],
                        tb["adj"], self.params, self.st_iter, aux=avs,
                        owned=tb["owned"])
                for f, v in enumerate(views):
                    out[f].append(v.view(t0.shape))
            return out

        self.fuse = 1
        self._one = one
        self._exec_plan = {"backend": "jnp", "fuse": 1, "exchange": "shift",
                           "kernels": []}

    # ------------------------------------------------------------------
    def differentiable_step(self, *args, **kw):
        raise not_ported("Problem.differentiable_step",
                         AUTODIFF_ITEM if len(self.dims) == 3
                         else RANKS_ITEM)

    def differentiable_rollout(self, *args, **kw):
        raise not_ported("Problem.differentiable_rollout",
                         AUTODIFF_ITEM if len(self.dims) == 3
                         else RANKS_ITEM)

    def export_step(self, *args, **kw):
        raise not_ported("Problem.export_step", REST_ITEM)

    @property
    def _ndev(self) -> int:
        return int(np.prod(self.eff_mesh))

    def _coords(self, rank: int) -> tuple[int, ...]:
        """Rank ``rank``'s block coordinates (ravel order over
        ``eff_mesh``)."""
        return tuple(int(c) for c in np.unravel_index(rank, self.eff_mesh))

    def _flat(self, state):
        """A state as the reference's stacked storage ``[ranks * nbricks,
        ...]`` on its card, or, on several cards, the per-card list."""
        if len(state) > 1:
            return state
        return state[0].view((-1,) + tuple(state[0].shape[2:]))

    @property
    def _dats(self):
        """Per evolving field, its storage: ``[ranks * nbricks, ...]``
        stacked along the brick axis in ravel order (the reference's
        layout) where every rank is on one card; the per-card states
        otherwise."""
        if self._states is None:
            return None
        return tuple(self._flat(s) for s in self._states)

    @property
    def _aux(self):
        return tuple(self._flat(s) for s in self._aux_states)

    def owned_mask(self) -> torch.Tensor:
        """Broadcastable 0/1 mask over the stacked storage selecting each
        rank's OWNED brick rows (storage rank 3 for the flat-pencil
        backend), on the device of rank 0."""
        m = np.tile(self.dec.owned_mask(), self._ndev)
        srank = 3 if self.backend == "mxu" else 1 + len(self.bdims)
        m = m.reshape((-1,) + (1,) * (srank - 1))
        return torch.from_numpy(np.ascontiguousarray(m)).to(self.device)

    def describe(self) -> dict:
        """The chosen execution plan: backend, temporal-fuse factor,
        exchange form per domain axis, and per kernel its tile, shared
        memory and folded tap counts."""
        nd = len(self.dims)
        form = self._exec_plan.get("exchange", "shift")
        per_axis = {}
        for a in range(nd):
            if self.eff_mesh[a] == 1:
                per_axis[a] = ("table-periodic" if self.backend == "pencil"
                               else "local ghost copy")
            elif a == 0 and self.slices > 1:
                per_axis[a] = (f"{form} ppermute over (slice x ici): "
                               f"{self.slices} DCN slices x "
                               f"{self.mesh_shape[0]} ICI")
            else:
                per_axis[a] = f"{form} ppermute over ICI"
        return {
            "dims": list(self.dims), "bdims": list(self.bdims),
            "mesh": list(self.mesh_shape), "slices": self.slices,
            "eff_mesh": list(self.eff_mesh),
            "st_iter": self.st_iter,
            "dtype": np.dtype(self.dtype).name,
            "fields": list(self.fields), "aux": list(self.aux_names),
            "exchange_axes": per_axis,
            **({"schedule": dict(self.schedule)} if self.schedule
               else {}),
            **self._exec_plan,
            "device": str(self.device),
        }

    # ------------------------------------------------------------------
    def _stack_global(self, array) -> list[np.ndarray]:
        """Global periodic array (``eff_mesh * dims``) -> each rank's brick
        storage, ravel order (ghost filled by wrap)."""
        nd = len(self.dims)
        gshape = tuple(m * d for m, d in zip(self.eff_mesh, self.dims))
        array = np.asarray(array, dtype=self.dtype)
        if array.shape != gshape:
            raise ValueError(f"global array must be {gshape}")
        nb = self.dec.nbricks
        out = []
        for r in range(self._ndev):
            c = self._coords(r)
            idx = [np.arange(c[a] * self.dims[a] - self.ghost[a],
                             (c[a] + 1) * self.dims[a] + self.ghost[a])
                   % gshape[a] for a in range(nd)]
            dat = np.zeros((nb, int(np.prod(self.bdims))), self.dtype)
            to_bricks(np.ascontiguousarray(array[np.ix_(*idx)]),
                      self.dec.grid, self.bdims, dat=dat)
            if self.backend == "mxu":   # flat-pencil storage (a view)
                out.append(dat.reshape(nb, self.bdims[0], -1))
            else:
                out.append(dat.reshape((-1,) + self.bdims))
        return out

    def init(self, array=None, seed: int = 0, aux=None):
        """Load the owned data from global arrays (shape ``mesh * dims``,
        periodic) or random values.  Single-field problems take
        ``array=<array>``; stencil systems take ``array={field: array}``
        (missing fields default to seeded random).  ``aux``: dict of
        global arrays for the static auxiliary fields."""
        gshape = tuple(m * d for m, d in zip(self.eff_mesh, self.dims))
        if self.nfld == 1 and not isinstance(array, dict):
            array = {self.gname: array}
        elif array is not None and not isinstance(array, dict):
            raise TypeError(
                f"a {self.nfld}-field system takes array={{field: "
                f"global_array}} with fields {list(self.fields)}")
        array = dict(array) if array else {}
        extra_f = [n for n in array if n not in self.fields]
        if extra_f:
            raise ValueError(f"unknown state fields {extra_f}; "
                             f"evolving fields are {list(self.fields)}")
        aux = dict(aux or {})
        missing = [n for n in self.aux_names if n not in aux]
        if missing:
            raise ValueError(f"init() needs aux arrays for stencil "
                             f"inputs {missing}")
        extra = [n for n in aux if n not in self.aux_names]
        if extra:
            raise ValueError(f"unknown aux fields {extra}; stencil aux "
                             f"inputs are {self.aux_names}")
        with trace.span(trace.PLAN), trace.span(trace.PLAN_DOMAIN):
            for i, f_ in enumerate(self.fields):
                if array.get(f_) is None:
                    array[f_] = random_array(gshape, self.dtype, seed + i)
            aux_stk = [self._stack_global(aux[n]) for n in self.aux_names]
            dat_stk = [self._stack_global(array[f_]) for f_ in self.fields]
            self._aux_states = tuple(to_state(self.mesh, s)
                                     for s in aux_stk)
            self._states = tuple(to_state(self.mesh, s) for s in dat_stk)
        return self

    @property
    def state(self):
        """The evolving fields' state as :meth:`advance` takes it: per
        field (``fields`` order), per card a ``[ranks, nbricks, ...]``
        tensor (``[ranks, nbricks, BK, BJ*BI]`` on the flat-pencil
        backend); None before :meth:`init`."""
        return self._states

    def advance(self, state) -> tuple:
        """One step of ``st_iter`` iterations of ``state`` (the form of
        :attr:`state`), as :meth:`step` runs it; returns the new state and
        leaves the problem's own as it was.  Inside a ``bricklib.step``
        span (its argument: the problem's count of steps)."""
        self._steps += 1
        with trace.span(trace.STEP, step=self._steps):
            return tuple(self._one(state, self._aux_states))

    def step(self, n: int = 1):
        """Advance ``n`` steps of ``st_iter`` stencil iterations each."""
        if self._states is None:
            raise RuntimeError("call init() first")
        for _ in range(n):
            self._states = self.advance(self._states)
        return self

    def rollout(self, n: int):
        """Advance ``n`` steps: the reference's one-dispatch chain, here a
        loop of :meth:`step` (PyTorch runs eagerly); identical to
        ``step(n)``."""
        n = int(n)
        if n < 1:
            raise ValueError("rollout needs n >= 1")
        return self.step(n)

    def _host(self, state) -> np.ndarray:
        """A state as the reference's stacked host array, ravel order."""
        return np.concatenate([v.detach().cpu().numpy()
                               for v in rank_views(self.mesh, state)])

    def save(self, path: str):
        """Checkpoint the brick state and the problem's configuration, in
        the reference's ``.npz`` layout (every rank's storage stacked
        along the brick axis, ravel order)."""
        if self._states is None:
            raise RuntimeError("nothing to save; call init() first")
        np.savez_compressed(
            path,
            dat=self._host(self._states[0]),
            dims=np.asarray(self.dims),
            mesh=np.asarray(self.mesh_shape),
            slices=np.asarray(self.slices),
            bdims=np.asarray(self.bdims),
            ghost=np.asarray(self.ghost),
            **{f"dat_{n}": self._host(s)
               for n, s in zip(self.fields[1:], self._states[1:])},
            **{f"aux_{n}": self._host(s)
               for n, s in zip(self.aux_names, self._aux_states)})
        return self

    def load(self, path: str):
        """Restore a checkpoint saved by :meth:`save`, or by the
        reference's ``Problem.save`` (the configuration must match this
        Problem; the flat-pencil backend's state is ``(nbricks, BK,
        BJ*BI)`` per rank)."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        for name, mine in (("dims", self.dims), ("mesh", self.mesh_shape),
                           ("slices", (self.slices,)),
                           ("bdims", self.bdims), ("ghost", self.ghost)):
            if name == "slices" and name not in z:
                got = (1,)
            else:
                got = tuple(np.atleast_1d(z[name]))
            if got != tuple(mine):
                raise ValueError(
                    f"checkpoint {name} {got} != {tuple(mine)}")
        keys = ["dat"] + [f"dat_{n}" for n in self.fields[1:]]
        missing = ([k for k in keys[1:] if k not in z]
                   + [n for n in self.aux_names if f"aux_{n}" not in z])
        if missing:
            raise ValueError(f"checkpoint lacks fields {missing}")

        def state(a):
            host = storage_from_reference(a, "cpu").numpy()
            return to_state(self.mesh, np.split(host, self._ndev))

        self._states = tuple(state(z[k]) for k in keys)
        self._aux_states = tuple(state(z[f"aux_{n}"])
                                 for n in self.aux_names)
        return self

    def _gather(self, state) -> np.ndarray:
        nd = len(self.dims)
        nb = self.dec.nbricks
        gshape = tuple(m * d for m, d in zip(self.eff_mesh, self.dims))
        full = np.zeros(gshape, self.dtype)
        for r, v in enumerate(rank_views(self.mesh, state)):
            own = from_bricks(np.ascontiguousarray(
                v.detach().cpu().numpy().reshape(nb, -1)),
                self.dec.interior_grid(), self.bdims)
            c = self._coords(r)
            full[tuple(slice(c[a] * self.dims[a], (c[a] + 1) * self.dims[a])
                       for a in range(nd))] = own
        return full

    def result(self, field: str | None = None):
        """Gather the owned region back to dense global array(s):
        single-field problems return the array; systems return ``{field:
        array}`` (or one array when ``field`` names one)."""
        if self._states is None:
            raise RuntimeError("no state; call init() first")
        if field is not None:
            if field not in self.fields:
                raise ValueError(f"unknown field {field!r}")
            return self._gather(self._states[self.fields.index(field)])
        if self.nfld == 1:
            return self._gather(self._states[0])
        return {f_: self._gather(s)
                for f_, s in zip(self.fields, self._states)}
