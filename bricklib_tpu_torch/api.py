"""High-level API on PyTorch: declare a stencil problem, step it, read it
back (port of ``bricklib_tpu/api.py``, one device).

    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(16384, 16384), stencil=box9, st_iter=4)  # one card
    p.init(seed=0)                # or p.init(array=my_numpy_array)
    p.step(5)                     # 5 steps of st_iter iterations each
    out = p.result()              # dense numpy array (owned region)

The port runs the pencil backend on one device, with every axis
periodic through the grid table (no ghost exchange): rank 2 over kernel
K6 (``codegen.pencil_kernel_2d``: single fields, aux fields and stencil
systems), ranks 3 and 4 over kernels K1 and K4 (single-field,
single-input stencils).  ``device`` defaults to ``cuda`` and raises where
there is none; the tests pass ``device="cpu"``, which runs the kernels'
plain versions.  The reference's other options raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from .codegen.evaluate import resolve_const_from_params
from .codegen.ir import (PASS_FUSE_MAX, StencilIR, fold_linear,
                         generic_pass_estimate, vpu_pass_estimate)
from .codegen.pencil_kernel import FEATURES_ITEM, pencil_sweep
from .codegen.pencil_kernel_2d import pencil_sweep_2d
from .codegen.pencil_kernel_4d import pencil_sweep_4d, tile_4d
from .comm import BrickDecomp, skinlist_by_name
from .comm.exchange import MULTI_GPU_ITEM
from .core import not_ported, random_array, require_device
from .core.setup import from_bricks, to_bricks
from .st.loader import StencilDef
from .stencils import bench_params, stencil_by_name

ORACLE_ITEM = "the torch oracle (dense_apply/brick_apply)"
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
                 schedule=None, device="cuda"):
        """Arguments as the reference's ``Problem`` (multi-input stencils
        take ``field`` and static aux fields; systems take a list of
        StencilDefs and ``field=(name1, ...)``; ``schedule`` takes
        ``fuse``, ``fuse_passes``, ``lookahead``, ``tile_j`` and
        ``vmem_limit_mb``, of which the last three are TPU knobs, accepted
        and ignored), plus ``device``."""
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
        if int(np.prod(self.eff_mesh)) > 1:
            raise not_ported(f"a mesh of {int(np.prod(self.eff_mesh))} "
                             "devices", MULTI_GPU_ITEM)
        if backend == "jnp":
            raise not_ported("backend='jnp'", ORACLE_ITEM)
        if backend == "mxu":
            raise not_ported("backend='mxu' (kernel 9)", REST_ITEM)
        if backend != "pencil":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        if bdims is None:
            by2 = (32 if nd == 2 and self.dims[0] % 32 == 0
                   and self.dims[0] >= 128 else 8)
            bdims = ((by2, self.dims[1]) if nd == 2
                     else (8, 8, self.dims[2]) if nd == 3
                     else (2, 8, 8, self.dims[3]))
        self.bdims = tuple(int(b) for b in bdims)
        if ghost is None:
            ghost = self.bdims[:-1] + (0,)
        self.ghost = tuple(int(g) for g in ghost)

        if exchange not in ("shift", "fused"):
            raise ValueError("exchange is 'shift' or 'fused'")
        if exchange == "fused" and (self.aux_names or nfld > 1):
            raise ValueError("exchange='fused' supports single-field, "
                             "single-input stencils; use "
                             "exchange='shift'")
        if exchange == "fused" and nd != 3:
            raise ValueError("exchange='fused' is 3-D pencil only")
        if exchange == "fused":
            raise not_ported("exchange='fused'", "kernel-level exchanges")
        self.exchange = exchange
        if np.dtype(dtype) != np.float32:
            raise not_ported(f"dtype {np.dtype(dtype).name}", FEATURES_ITEM)
        self.dtype = np.dtype(dtype)
        if nd in (3, 4) and (nfld > 1 or self.aux_names):
            raise not_ported(f"aux fields and stencil systems on rank {nd}",
                             FEATURES_ITEM)
        self.device = require_device(device)
        self.dec = BrickDecomp(dims=self.dims, ghost_depth=self.ghost,
                               bdims=self.bdims).initialize(
            skinlist_by_name("good", nd))

        self.st_iter = int(st_iter)
        rad = max(max(max(lo_r), max(hi_r))
                  for lo_r, hi_r in (s.radius() for s in sdefs))
        dec, bd = self.dec, self.bdims
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

        # one device: every axis is periodic through the grid table
        table_axes = tuple(range(nd))
        kgrid = dec.periodic_grid(table_axes)
        if nd == 2:
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
            GY = kgrid.shape[0]
            kern = pencil_sweep_2d(
                sdefs if nfld > 1 else self.sdef, kgrid, bd, dec.nbricks,
                self.params, y_range=(1, GY - 1), fuse=fuse)
            plan = kern.plan
            info = {"kernel": "K6 pencil_sweep_2d",
                    "taps": (None if plan.taps is None
                             else [len(t) for t in plan.taps])}
            if plan.taps is not None:
                info["tile_x"], info["smem_bytes"] = plan.tile()
        else:
            fuse = 1
            if _sch_fuse is not None:
                fuse = _fit_fuse(
                    _sch_fuse, self.st_iter,
                    lambda c: all(c * rad <= b for b in bd[:-1]))
            else:
                np_ = _passes(sdefs[0], self.params)
                if np_ is None:
                    np_ = generic_pass_estimate(sdefs[0])
                top = 4 if nd == 3 else 2
                cands = (4, 2) if np_ <= pass_max else ()
                for cand in (c for c in cands if c <= top):
                    if (self.st_iter % cand == 0 and self.st_iter
                            and all(cand * rad <= b for b in bd[:-1])):
                        fuse = cand
                        break
            rng = {f"{'wkj'[a + 4 - nd]}_range": (1, kgrid.shape[a] - 1)
                   for a in range(nd - 1)}
            sweep = pencil_sweep if nd == 3 else pencil_sweep_4d
            kern = sweep(self.sdef, kgrid, bd, dec.nbricks, self.params,
                         fuse=fuse, **rng)
            plan = kern.plan
            info = {"kernel": ("K1 pencil_sweep" if nd == 3
                               else "K4 pencil_sweep_4d"),
                    "taps": (None if plan.taps is None
                             else [len(plan.taps.coeffs)])}
            if plan.taps is not None and nd == 3:
                info["tile_i"], info["smem_bytes"] = plan.tile()
            elif plan.taps is not None:
                (info["tile_w"], info["tile_i"],
                 info["smem_bytes"]) = tile_4d(plan)
        self.fuse = fuse
        nsweeps = self.st_iter // fuse
        self._kern = kern

        def one(*sv):
            states = list(sv[:nfld])
            vs = dict(zip(self.aux_names, sv[nfld:]))
            for _ in range(nsweeps):
                vs.update(zip(self.fields, states))
                outs = (kern(*(vs[n] for n in kern.fields))
                        if hasattr(kern, "fields") else kern(states[0]))
                states = list(outs) if nfld > 1 else [outs]
            return states

        self._one = one
        self._exec_plan = {
            "backend": "pencil", "fuse": fuse, "exchange": "table",
            "table_axes": list(table_axes), "kernels": [info],
        }
        self._dats = None
        self._aux = ()

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

    def owned_mask(self) -> torch.Tensor:
        """Broadcastable 0/1 mask over the storage selecting the OWNED
        brick rows."""
        m = self.dec.owned_mask()
        m = m.reshape((-1,) + (1,) * len(self.bdims))
        return torch.from_numpy(np.ascontiguousarray(m)).to(self.device)

    def describe(self) -> dict:
        """The chosen execution plan: backend, temporal-fuse factor,
        exchange form per domain axis, and per kernel its tile, shared
        memory and folded tap counts."""
        nd = len(self.dims)
        return {
            "dims": list(self.dims), "bdims": list(self.bdims),
            "mesh": list(self.mesh_shape), "slices": self.slices,
            "eff_mesh": list(self.eff_mesh),
            "st_iter": self.st_iter,
            "dtype": np.dtype(self.dtype).name,
            "fields": list(self.fields), "aux": list(self.aux_names),
            "exchange_axes": {a: "table-periodic" for a in range(nd)},
            **({"schedule": dict(self.schedule)} if self.schedule
               else {}),
            **self._exec_plan,
            "device": str(self.device),
        }

    # ------------------------------------------------------------------
    def _stack_global(self, array) -> np.ndarray:
        """Global periodic array -> brick storage (ghost filled by
        wrap)."""
        gshape = self.dims
        array = np.asarray(array, dtype=self.dtype)
        if array.shape != gshape:
            raise ValueError(f"global array must be {gshape}")
        nd = len(self.dims)
        nb = self.dec.nbricks
        idx = [np.arange(-self.ghost[a], self.dims[a] + self.ghost[a])
               % gshape[a] for a in range(nd)]
        dat = np.zeros((nb, int(np.prod(self.bdims))), self.dtype)
        to_bricks(np.ascontiguousarray(array[np.ix_(*idx)]), self.dec.grid,
                  self.bdims, dat=dat)
        return dat.reshape((-1,) + self.bdims)

    def _put(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device)

    def init(self, array=None, seed: int = 0, aux=None):
        """Load the owned data from global arrays (shape ``dims``,
        periodic) or random values.  Single-field problems take
        ``array=<array>``; stencil systems take ``array={field: array}``
        (missing fields default to seeded random).  ``aux``: dict of
        global arrays for the static auxiliary fields."""
        gshape = self.dims
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
        for i, f_ in enumerate(self.fields):
            if array.get(f_) is None:
                array[f_] = random_array(gshape, self.dtype, seed + i)
        aux = dict(aux or {})
        missing = [n for n in self.aux_names if n not in aux]
        if missing:
            raise ValueError(f"init() needs aux arrays for stencil "
                             f"inputs {missing}")
        extra = [n for n in aux if n not in self.aux_names]
        if extra:
            raise ValueError(f"unknown aux fields {extra}; stencil aux "
                             f"inputs are {self.aux_names}")
        aux_stk = [self._stack_global(aux[n]) for n in self.aux_names]
        dat_stk = [self._stack_global(array[f_]) for f_ in self.fields]
        self._aux = tuple(self._put(s) for s in aux_stk)
        self._dats = tuple(self._put(s) for s in dat_stk)
        return self

    def step(self, n: int = 1):
        """Advance ``n`` steps of ``st_iter`` stencil iterations each."""
        if self._dats is None:
            raise RuntimeError("call init() first")
        for _ in range(n):
            self._dats = tuple(self._one(*self._dats, *self._aux))
        return self

    def rollout(self, n: int):
        """Advance ``n`` steps: the reference's one-dispatch chain, here a
        loop of :meth:`step` (PyTorch runs eagerly); identical to
        ``step(n)``."""
        n = int(n)
        if n < 1:
            raise ValueError("rollout needs n >= 1")
        return self.step(n)

    def save(self, path: str):
        """Checkpoint the brick state and the problem's configuration, in
        the reference's ``.npz`` layout."""
        if self._dats is None:
            raise RuntimeError("nothing to save; call init() first")

        def host(t):
            return t.detach().cpu().numpy()

        np.savez_compressed(
            path,
            dat=host(self._dats[0]),
            dims=np.asarray(self.dims),
            mesh=np.asarray(self.mesh_shape),
            slices=np.asarray(self.slices),
            bdims=np.asarray(self.bdims),
            ghost=np.asarray(self.ghost),
            **{f"dat_{n}": host(a)
               for n, a in zip(self.fields[1:], self._dats[1:])},
            **{f"aux_{n}": host(a)
               for n, a in zip(self.aux_names, self._aux)})
        return self

    def load(self, path: str):
        """Restore a checkpoint saved by :meth:`save` (the configuration
        must match this Problem)."""
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
        self._dats = tuple(self._put(np.ascontiguousarray(z[k]))
                           for k in keys)
        self._aux = tuple(self._put(np.ascontiguousarray(z[f"aux_{n}"]))
                          for n in self.aux_names)
        return self

    def _gather(self, dat) -> np.ndarray:
        out = dat.detach().cpu().numpy()
        nb = self.dec.nbricks
        return from_bricks(np.ascontiguousarray(out.reshape(nb, -1)),
                           self.dec.interior_grid(), self.bdims)

    def result(self, field: str | None = None):
        """Gather the owned region back to dense array(s): single-field
        problems return the array; systems return ``{field: array}`` (or
        one array when ``field`` names one)."""
        if self._dats is None:
            raise RuntimeError("no state; call init() first")
        if field is not None:
            if field not in self.fields:
                raise ValueError(f"unknown field {field!r}")
            return self._gather(self._dats[self.fields.index(field)])
        if self.nfld == 1:
            return self._gather(self._dats[0])
        return {f_: self._gather(d)
                for f_, d in zip(self.fields, self._dats)}
