"""Weak-scaling driver on PyTorch: ghost exchange + fused pencil sweeps
over a mesh of ranks, validated per rank against the dense numpy twin of
its block (port of ``bricklib_tpu/drivers/weak.py``; ref:
weak/main.cpp:38-306 and weak/main-4d.cpp for 4-D domains).

Each rank's block is cut from one global periodic domain.  On the pencil
backend one step is one exchange that moves real ghost bricks, then
``st_iter / fuse`` pencil sweeps (kernel K1 on a 3-D domain, K4 on a 4-D
one), ghost-inclusive except the last, each one launch per card over all
the card's ranks.  The
exchange is ``shift`` (the multi-stage SHIFT exchange: kernel K2 on
one-rank axes, ``Tensor.copy_`` between ranks), ``put`` (one copy per
ghost run and rank, K2 for self-copies), ``shift-remote`` (kernel K9,
one launch per stage and card) or ``fused`` (3-D, ``fuse=1``: kernel
K11 carries the PUT copies and the first sweep, one launch per card; the
other ``st_iter - 1`` sweeps are K1's).  Axes of one rank go through the grid
table unless ``--no-table-periodic`` (the honest configuration on one
card); the i axis always does.  Reported: GStencil/s over every rank's
domain and ms per step, the marginal exchange share, the phase
statistics, and the step's ratio to the copy speed of light (kernel K3).

``backend="jnp"``, the reference's default, runs the torch oracle at any
rank and on any mesh: bricks a whole brick deep in ghosts on every axis,
i included; one exchange (``shift``, ``put`` or ``shift-remote``) over
every axis, then ``st_iter`` ghost-inclusive ``brick_apply`` iterations,
the last over the owned bricks only, one ``brick_apply`` per card over all
its ranks.  ``--overlap`` splits its first iteration: the inner bricks
(``sep_pos``) before the exchange, the ring after it.  ``--f64-validate``
also runs the numpy ``brick_apply`` in float64 on rank 0's block against
the float64 dense twin at the reference's 1e-6.

``backend="pencil"`` runs on 3-D and 4-D domains with the innermost mesh
axis of one rank, as the reference requires.  A mesh's ranks may share a
card (``devices=["cuda:0"] * 4``); without ``devices`` a mesh of several
ranks takes one card each and raises where there are too few.
``--overlap`` on the pencil backend raises ``NotImplementedError`` naming
the ROADMAP.md item that brings it.  ``--profile DIR`` runs ``iters`` more
steps under ``torch.profiler`` with the program's spans on
(:mod:`..trace`), writes the Chrome trace ``weak_trace.json`` into DIR
and prints the host and device ms under each span name.
``--device`` defaults to ``cuda`` and raises where there is none: nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..bench.roofline import chain, copy_storage
from ..bench.timing import mpi_statistics, time_mpi
from ..codegen.fused_exchange import pencil_sweep_fusedx
from ..codegen.jnp_backend import (CardTables, brick_apply, dense_apply,
                                   oracle_iterate)
from ..codegen.pencil_kernel import pencil_sweep
from ..codegen.pencil_kernel_4d import pencil_sweep_4d
from ..codegen.schedule import StepSweeps, outer_ranges
from ..comm import BrickDecomp, skinlist_by_name
from ..comm.exchange import (on_card, put_exchange, put_plan,
                             shift_exchange, shift_remote_exchange)
from ..comm.mesh import rank_views, run_mesh, to_state
from ..core import BRICK_TOLERANCE, compare_arrays, not_ported, random_array
from ..core.setup import from_bricks as from_bricks_np
from ..core.setup import to_bricks
from ..stencils import bench_params, stencil_by_name

EXCHANGES = {"shift": shift_exchange, "put": put_exchange,
             "shift-remote": shift_remote_exchange}


@dataclass
class WeakStep:
    """A built step: ``step(state)`` (exchange in place, then the sweeps;
    returns the new state) and ``step_noex(state)`` (the sweeps alone) on
    ``state`` (one ``[p, nbricks, *bdim]`` tensor per card of ``mesh``);
    ``calls`` counts their calls.  ``g`` is the global domain the ranks'
    blocks are cut from (:meth:`block`)."""

    step: object
    step_noex: object
    state: list
    dec: BrickDecomp
    mesh: object
    g: np.ndarray
    bdim: tuple
    gz: tuple
    moves_data: bool
    calls: dict
    exchange: object = None

    def block(self, rank: int) -> np.ndarray:
        """Rank ``rank``'s block with its ghost shell, from ``g``."""
        c = self.mesh.coords_of(rank)
        dims = self.dec.dims
        idx = [np.arange(c[a] * dims[a] - self.gz[a],
                         (c[a] + 1) * dims[a] + self.gz[a]) % self.g.shape[a]
               for a in range(len(dims))]
        return self.g[np.ix_(*idx)]


def _check_supported(dims, mesh_shape, backend, exchange, overlap,
                     profile_dir, fuse):
    if backend not in ("jnp", "pencil"):
        raise ValueError(f"unknown backend {backend!r}")
    if exchange == "fused" and backend != "pencil":
        raise ValueError("--exchange fused runs on the pencil backend")
    if exchange == "fused":
        _check_fused(len(dims), fuse, overlap)
    elif exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    if overlap and backend == "pencil":
        raise not_ported("--overlap", "remaining pencil_sweep features "
                         "(inplace)")
    if len(mesh_shape) != len(dims):
        raise ValueError(f"--mesh {tuple(mesh_shape)} needs one entry per "
                         f"axis of the {len(dims)}-D domain")
    if backend == "pencil" and (len(dims) not in (3, 4)
                                or mesh_shape[-1] != 1):
        # as the reference driver: 2-D domains run through api.Problem
        raise ValueError("pencil backend: 3-D or 4-D, innermost axis "
                         "undistributed")


def _check_fused(nd: int, fuse: int, overlap: bool = False) -> None:
    if nd != 3 or fuse != 1 or overlap:
        raise ValueError("--exchange fused: 3-D pencil backend, fuse=1, no "
                         "--overlap (the fusion IS the overlap)")


def _make_step(*args, **kw) -> WeakStep:
    """The step of :func:`_plan_step`'s arguments, planned inside a
    ``bricklib.plan`` span."""
    with trace.span(trace.PLAN):
        return _plan_step(*args, **kw)


def _plan_step(dims, bdim, stencil, st_iter, fuse, table_periodic, skin,
               device, quiet=False, mesh_shape=None, exchange="shift",
               devices=None, backend="pencil", overlap=False) -> WeakStep:
    nd = len(dims)
    mesh_shape = tuple(int(m) for m in (mesh_shape or (1,) * nd))
    mesh = run_mesh(mesh_shape, device, devices)
    sd = stencil_by_name(stencil)[0]
    lo_r, hi_r = sd.radius()
    rad = max(max(lo_r), max(hi_r))
    if backend == "jnp":
        # the oracle's bricks as given, a whole brick of ghost on every
        # axis (ref: weak.py:64-65)
        bdim = tuple(int(b) for b in bdim)
        gz = bdim
    else:
        bdim = tuple(int(b) for b in bdim[:nd - 1]) + (int(dims[-1]),)
        gz = bdim[:nd - 1] + (0,)
        # deep-ghost ST_ITER bound (ref: weak/main.cpp:203-212)
        if ((any(m > 1 for m in mesh_shape) or not table_periodic)
                and st_iter * rad > min(bdim[:nd - 1])):
            raise ValueError(f"st_iter {st_iter} x radius {rad} exceeds "
                             f"ghost depth {min(bdim[:nd - 1])}")
        if st_iter % fuse:
            raise ValueError("st_iter must be a multiple of fuse")
    with trace.span(trace.PLAN_DECOMP):
        dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=bdim).initialize(
            skinlist_by_name(skin, nd))
    if not quiet:
        print(f"skin ordering '{skin}': {len(dec.ghost)} ghost runs "
              f"(PUT messages), {len(dec.sections)} sections")
    # every rank's block with its ghost shell, cut from one global
    # periodic domain (ref: weak.py:90-110)
    with trace.span(trace.PLAN_DOMAIN):
        gshape = tuple(m * d for m, d in zip(mesh_shape, dims))
        g = random_array(gshape, np.float32, seed=3)
        s = WeakStep(None, None, [], dec, mesh, g, bdim, gz, False,
                     {"step": 0, "step_noex": 0})
        arrays = []
        for r in range(mesh.size):
            dat = np.zeros((dec.nbricks, int(np.prod(bdim))), np.float32)
            to_bricks(s.block(r), dec.grid, bdim, dat=dat)
            dat[dec.sep_pos[1]:] = 0
            arrays.append(dat.reshape((-1,) + bdim))
        s.state = to_state(mesh, arrays)
        del arrays

    params = bench_params()
    if backend == "jnp":
        _oracle_step(s, sd, st_iter, params, exchange, overlap)
        return s
    # undistributed axes go through the table (zero-copy periodicity);
    # the i axis never exchanges: pencil rolls are periodic in i
    table_axes = tuple(a for a in range(nd)
                       if mesh_shape[a] == 1
                       and (table_periodic or a == nd - 1))
    kgrid = dec.periodic_grid(table_axes)
    sweep = pencil_sweep if nd == 3 else pencil_sweep_4d

    def make(p, ghost):
        return sweep(sd, kgrid, bdim, p * dec.nbricks, params,
                     **outer_ranges(kgrid, table_axes, ghost),
                     fuse=fuse, batch=p, batch_stride=dec.nbricks)

    s.moves_data = len(table_axes) < nd
    fused = None
    if exchange == "fused":
        _check_fused(nd, fuse)
        # the exchange fused into the first sweep (kernel K11), the
        # remaining st_iter - 1 sweeps plain (ref: weak.py:193-212)
        fused = pencil_sweep_fusedx(
            sd, kgrid, bdim, dec.nbricks, put_plan(dec, mesh_shape,
                                                   table_axes),
            mesh_shape, params, mesh=mesh,
            **outer_ranges(kgrid, table_axes, st_iter > 1))
        ex = None
        sweeps = StepSweeps(make, st_iter - 1, s.moves_data)
        noex = sweeps.longer(1)
    else:
        ex = EXCHANGES[exchange](dec, mesh, table_axes=table_axes) \
            if s.moves_data else None
        sweeps = noex = StepSweeps(make, st_iter // fuse, s.moves_data)

    def step(state):
        """Exchange (in place on ``state``) then the sweeps; with the
        fused exchange, K11 is the exchange and the first sweep."""
        s.calls["step"] += 1
        with trace.span(trace.STEP, step=s.calls["step"]):
            if fused is not None:
                return sweeps(fused(state)[0])
            if ex is not None:
                ex(state)
            return sweeps(state)

    def step_noex(state):
        """The step without its exchange: the exchange cost is measured
        differentially (step - step_noex)."""
        s.calls["step_noex"] += 1
        return noex(state)

    s.step, s.step_noex, s.exchange = step, step_noex, fused or ex
    return s


def _oracle_step(s: WeakStep, sd, st_iter, params, exchange, overlap):
    """Give ``s`` the oracle's step (ref: weak.py:158-176, :246-290): the
    exchange over every axis, then ``st_iter`` ``brick_apply`` iterations,
    ghost-inclusive except the last, which writes the owned bricks only;
    with ``overlap`` the first iteration's inner bricks (``sep_pos``) are
    computed before the exchange and its ring after.  The ranks of a card
    run as one ``brick_apply`` over their stacked storage; the adjacency
    and row lists are uploaded once per card."""
    dec, bdim = s.dec, s.bdim
    gname = next(iter(sd.inputs))
    nb = dec.nbricks
    ex = EXCHANGES[exchange](dec, s.mesh)
    s.moves_data = True
    tables = CardTables(nb, adj=dec.info.adj,
                        owned=np.arange(1, dec.sep_pos[1]),
                        inner=np.arange(1, dec.sep_pos[0]),
                        ring=np.arange(dec.sep_pos[0], nb))

    def apply(v, tb, part):
        return brick_apply(sd, {gname: v}, tb["adj"], params, rows=tb[part])

    def iterate(state, first, start=None):
        """Iterations ``first..st_iter-1`` on every card; ``start``: per
        card, the storage they begin from (default: the state's)."""
        out = []
        for c, t in enumerate(state):
            tb = tables(t.device, t.shape[0])
            v = (t if start is None else start[c]).view((-1,) + bdim)
            with on_card(t.device):
                (v,) = oracle_iterate((sd,), (gname,), (v,), tb["adj"],
                                      params, st_iter - first,
                                      owned=tb["owned"])
            out.append(v.view(t.shape))
        return out

    def step(state):
        s.calls["step"] += 1
        with trace.span(trace.STEP, step=s.calls["step"]):
            return _step(state)

    def _step(state):
        if not overlap:
            ex(state)
            return iterate(state, 0)
        inner = []
        for t in state:
            with on_card(t.device):
                inner.append(apply(t.view((-1,) + bdim),
                                   tables(t.device, t.shape[0]), "inner"))
        ex(state)
        first = []
        for t, o in zip(state, inner):
            tb, v = tables(t.device, t.shape[0]), t.view((-1,) + bdim)
            with on_card(t.device):
                ring = apply(v, tb, "ring")
                v.index_copy_(0, tb["inner"], o)
                v.index_copy_(0, tb["ring"], ring)
            first.append(v)
        return iterate(state, 1, first)

    def step_noex(state):
        s.calls["step_noex"] += 1
        return iterate(state, 0)

    s.step, s.step_noex, s.exchange = step, step_noex, ex


def build_step(dims=(64, 64, 64), bdim=(8, 8, 128), stencil="mpi7pt",
               st_iter=8, fuse=1, table_periodic=True, skin="good",
               device="cuda", mesh_shape=None, exchange="shift",
               devices=None, backend="pencil", overlap=False):
    """``(step_fn, storage, dec)`` of the pencil step (or, with
    ``backend="jnp"``, the oracle's), for holding it against the
    reference.  On a mesh of one rank ``storage`` is its
    ``[nbricks, *bdim]`` tensor and ``step_fn`` maps such a tensor (the
    exchange in place) to the new one; on a larger mesh both take the
    state, one ``[p, nbricks, *bdim]`` tensor per card."""
    s = _make_step(tuple(dims), bdim, stencil, st_iter, fuse,
                   table_periodic, skin, device, quiet=True,
                   mesh_shape=mesh_shape, exchange=exchange, devices=devices,
                   backend=backend, overlap=overlap)
    if s.mesh.size > 1:
        return s.step, s.state, s.dec
    return (lambda t: s.step([t.unsqueeze(0)])[0][0]), s.state[0][0], s.dec


def clone_state(state) -> list:
    return [t.clone() for t in state]


def validate_step(s: WeakStep, stencil: str, st_iter: int) -> bool:
    """One step against the dense numpy twin of every rank's block at 1e-4
    on the owned region that st_iter halo sweeps leave exact (ref:
    weak.py:324-348).  The twin takes the coefficients the sweeps took
    (``bench_params()``)."""
    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    out = rank_views(s.mesh, s.step(clone_state(s.state)))
    lo, hi = sd.radius()
    dims = s.dec.dims
    nd = len(dims)
    own = tuple(slice(s.gz[a], s.gz[a] + dims[a]) for a in range(nd))
    m = [max(st_iter * max(l, h) - s.gz[a], 0)
         for a, (l, h) in enumerate(zip(lo, hi))]
    sl = tuple(slice(m[a], dims[a] - m[a]) for a in range(nd))
    ok = True
    for r, view in enumerate(out):
        b = s.block(r)
        for _ in range(st_iter):
            nxt = dense_apply(sd, {gname: b}, bench_params(), xp=np)
            b2 = np.zeros_like(b)
            b2[tuple(slice(l, n - h) for l, n, h in zip(lo, b.shape, hi))] = \
                nxt
            b = b2
        got = from_bricks_np(view.cpu().numpy().reshape(s.dec.nbricks, -1),
                             s.dec.interior_grid(), s.bdim)
        ok &= compare_arrays(got[sl], b[own][sl], 1e-4)
    return ok


def f64_validate_step(s: WeakStep, stencil: str, st_iter: int) -> bool:
    """The reference's 1e-6 brickcompare contract (include/cmpconst.h:9)
    where it is defined, double precision: rank 0's block in float64
    through the numpy ``brick_apply`` (``st_iter`` iterations, no
    exchange) against the float64 dense twin on the owned region that
    ``st_iter`` halo sweeps leave exact (ref: weak.py:350-375)."""
    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    dec, bdim, gz = s.dec, s.bdim, s.gz
    nd = len(dec.dims)
    blk64 = s.block(0).astype(np.float64)
    dat64 = np.zeros((dec.nbricks, int(np.prod(bdim))), np.float64)
    to_bricks(blk64, dec.grid, bdim, dat=dat64)
    view64 = dat64.reshape((-1,) + bdim)
    b = blk64
    lo, hi = sd.radius()
    for _ in range(st_iter):
        view64 = brick_apply(sd, {gname: view64}, np.asarray(dec.info.adj),
                             bench_params(), xp=np)
        nxt = dense_apply(sd, {gname: b}, bench_params(), xp=np)
        b2 = np.zeros_like(b)
        b2[tuple(slice(l, n - h) for l, n, h in zip(lo, b.shape, hi))] = nxt
        b = b2
    own = tuple(slice(gz[a], gz[a] + dec.dims[a]) for a in range(nd))
    got64 = from_bricks_np(view64.reshape(dec.nbricks, -1),
                           dec.interior_grid(), bdim)
    m = [max(st_iter * max(l, h) - gz[a], 0)
         for a, (l, h) in enumerate(zip(lo, hi))]
    sl = tuple(slice(m[a], dec.dims[a] - m[a]) for a in range(nd))
    return compare_arrays(got64[sl], b[own][sl], BRICK_TOLERANCE)


def device_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (cuda)"
    return "cpu"


def mesh_label(mesh) -> str:
    """The mesh's cards and how many ranks each holds."""
    return ", ".join(f"{device_label(d)} x{len(mesh.ranks_on(c))}"
                     if len(mesh.ranks_on(c)) > 1 else device_label(d)
                     for c, d in enumerate(mesh.cards))


def run(dims=(64, 64, 64), bdim=(8, 8, 128), stencil="mpi7pt",
        st_iter=8, mesh_shape=None, iters=25, validate=True,
        overlap=False, backend="jnp", profile_dir=None,
        exchange="shift", table_periodic=True, skin="good",
        f64_validate=False, fuse=1, device="cuda", devices=None):
    """Build, validate and time the weak step on ``mesh_shape`` ranks
    (``devices``: one per rank, as :func:`~..comm.mesh.make_domain_mesh`
    takes them).  ``validate``: True for the dense numpy twin of every
    rank's block, or a function of the built :class:`WeakStep` returning
    whether its step holds.  Returns a dict of seconds (``step``,
    ``exchange``, ``copy``, ``phases``) and the number of calls made of
    each timed function (``calls``; ``copy`` counts one per card)."""
    dims = tuple(int(d) for d in dims)
    if mesh_shape is None:
        mesh_shape = (1,) * len(dims)
    mesh_shape = tuple(int(m) for m in mesh_shape)
    _check_supported(dims, mesh_shape, backend, exchange, overlap,
                     profile_dir, fuse)
    s = _make_step(dims, bdim, stencil, st_iter, fuse, table_periodic,
                   skin, device, mesh_shape=mesh_shape, exchange=exchange,
                   devices=devices, backend=backend, overlap=overlap)
    if validate:
        ok = (validate(s) if callable(validate)
              else validate_step(s, stencil, st_iter))
        if not ok:
            raise RuntimeError("validation mismatch vs array twin")
        print("validated against array twin: OK")
    if f64_validate:
        if not f64_validate_step(s, stencil, st_iter):
            raise RuntimeError("float64 validation mismatch at 1e-6")
        print(f"validated in float64 at {BRICK_TOLERANCE:g}: OK")

    avg, samples = time_mpi(s.step, clone_state(s.state), iters=iters)
    if s.moves_data:
        avg_nx, samples_x = time_mpi(s.step_noex, clone_state(s.state),
                                     iters=iters)
        avg_x = max(avg - avg_nx, 0.0)
    else:
        avg_x, samples_x = 0.0, [0.0]
    # the copy speed of light of the same storage (bench.py:391-402), one
    # K3 launch per card
    n_copy = [0]

    def copy_state(state):
        n_copy[0] += len(state)
        out = []
        for t in state:
            with on_card(t.device):
                out.append(copy_storage(t))
        return out

    t_copy, _ = chain(copy_state, s.state, iters)
    s.calls["copy"] = n_copy[0]

    gshape = s.g.shape
    elems = int(np.prod(gshape)) * st_iter
    ghost_bytes = (s.dec.nbricks - s.dec.sep_pos[1]) * int(
        np.prod(s.bdim)) * 4 * s.mesh.size
    store_bytes = sum(t.numel() * t.element_size() for t in s.state)
    copy_bw = 2 * store_bytes / t_copy
    sol_gst = 2 * elems / st_iter * 4 / t_copy / (2 * 4) / 1e9
    gst = elems / avg / 1e9
    label = mesh_label(s.mesh)
    print(f"device {label}")
    print(f"domain {gshape} mesh {mesh_shape} stencil {stencil} "
          f"ST_ITER {st_iter} backend {backend}"
          + (f" fuse {fuse}" if backend == "pencil" else "")
          + f" exchange {exchange}" + (" overlap" if overlap else ""))
    print(f"perf  {gst:8.3f} GStencil/s ({avg * 1e3:.3f} ms/step)")
    print(f"copy roofline {copy_bw / 1e9:.1f} GB/s "
          f"({t_copy * 1e3:.3f} ms/copy); step at {gst / sol_gst:.3f} "
          f"of the copy speed of light per iteration")
    if s.moves_data:
        print(f"exchange (marginal) {avg_x * 1e3:.3f} ms, ghost "
              f"{ghost_bytes / 1e6:.1f} MB"
              + (f", {2 * ghost_bytes / avg_x / 1e9:.1f} GB/s"
                 if avg_x > 1e-9 else ""))
        print(f"exchange share of step: {avg_x / avg * 100:.1f}%")
    else:
        print("exchange: none (all axes periodic through the table)")
    phases = {"packtime": 0.0, "calltime+waittime": avg_x,
              "movetime": 0.0, "calctime": max(avg - avg_x, 0.0)}
    print("  phases: " + "  ".join(f"{k} {v * 1e3:.3f}ms"
                                   for k, v in phases.items()))
    for nm, smp in (("step", samples), ("step-noex", samples_x)):
        st = mpi_statistics(smp)
        print(f"  {nm:9s} min {st['min'] * 1e3:7.3f} avg "
              f"{st['avg'] * 1e3:7.3f} max {st['max'] * 1e3:7.3f} sigma "
              f"{st['sigma'] * 1e3:7.3f} ms")
    spans = profile_steps(s, iters, profile_dir) if profile_dir else None
    return {"step": avg, "exchange": avg_x, "copy": t_copy,
            "copy_gbs": copy_bw / 1e9, "phases": phases,
            "gstencil_s": gst, "vs_copy_sol": gst / sol_gst,
            "calls": dict(s.calls), "device": label, "ranks": s.mesh.size,
            "cards": len(s.mesh.cards), "spans": spans}


def profile_steps(s: WeakStep, iters: int, out_dir) -> dict:
    """``iters`` steps of ``s`` from its state under ``torch.profiler``,
    the program's spans on; writes the Chrome trace
    ``out_dir/weak_trace.json`` and prints, per span name, the spans,
    their host ms and the device ms launched inside them
    (:func:`~..trace.span_times`, which it returns)."""
    from torch.profiler import ProfilerActivity, profile

    cards = [d for d in s.mesh.cards if d.type == "cuda"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards
                                     else [])
    state = clone_state(s.state)
    with profile(activities=acts) as prof, trace.tracing():
        for _ in range(iters):
            state = s.step(state)
        for d in cards:
            torch.cuda.synchronize(d)
    trace.records()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "weak_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        times = trace.span_times(json.load(f)["traceEvents"])
    print(f"trace {path}: {iters} steps")
    for name, (n, host, dev) in sorted(times.items()):
        print(f"  {name or '(outside every span)':24s} {n:6d} spans, host "
              f"{host:9.3f} ms, device {dev:9.3f} ms")
    return times


def _ints(text):
    return tuple(int(x) for x in text.split(","))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-d", "--dims", default="64,64,64",
                   help="per-rank domain")
    p.add_argument("-b", "--bdim", default="8,8,8")
    p.add_argument("-s", "--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=8)
    p.add_argument("--mesh", default=None,
                   help="ranks per axis (default: one per axis)")
    p.add_argument("--devices", default=None,
                   help="one device per rank, comma-separated, repeats "
                        "allowed (e.g. cuda:0,cuda:0,cuda:0,cuda:0); "
                        "default: one card per rank")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--overlap", action="store_true",
                   help="interior/boundary split of the first iteration "
                        "around the exchange (jnp backend)")
    p.add_argument("--backend", default="jnp", choices=["jnp", "pencil"],
                   help="jnp: the torch oracle, any rank; pencil: the "
                        "fused pencil sweeps, 3-D and 4-D")
    p.add_argument("--profile", dest="profile_dir", default=None,
                   help="after the timing, profile --iters more steps with "
                        "the program's spans on and write the Chrome trace "
                        "into this directory")
    p.add_argument("--exchange", default="shift",
                   choices=["shift", "put", "shift-remote", "fused"],
                   help="SHIFT multi-stage, PUT (one copy per ghost run), "
                        "shift-remote (kernel K9: one launch per stage and "
                        "card straight into the neighbours' ghosts), fused "
                        "(kernel K11: the PUT copies inside the first sweep, "
                        "3-D, --fuse 1)")
    p.add_argument("--no-table-periodic", action="store_true",
                   help="exchange real ghost bricks even on 1-device "
                        "axes (honest distributed config)")
    p.add_argument("--skin", default="good",
                   choices=["good", "normal", "bad", "lex"])
    p.add_argument("--f64-validate", action="store_true",
                   help="also validate the layout and executor in numpy "
                        "float64 at the 1e-6 brickcompare tolerance")
    p.add_argument("--fuse", type=int, default=1,
                   help="stencil iterations fused per pass over device "
                        "memory (must divide st_iter)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises when there is "
                        "no card")
    a = p.parse_args(argv)
    run(_ints(a.dims), _ints(a.bdim), a.stencil, a.st_iter,
        a.mesh and _ints(a.mesh), a.iters, validate=not a.no_validate,
        overlap=a.overlap, backend=a.backend, profile_dir=a.profile_dir,
        exchange=a.exchange, table_periodic=not a.no_table_periodic,
        skin=a.skin, f64_validate=a.f64_validate, fuse=a.fuse,
        device=a.device, devices=a.devices and a.devices.split(","))


if __name__ == "__main__":
    main()
