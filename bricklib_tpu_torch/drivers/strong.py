"""Strong-scaling driver on PyTorch: a fixed global domain cut into
Morton-ordered subdomains over a mesh of ranks, exchanged and swept in
batches, validated against the global dense numpy twin (port of
``bricklib_tpu/drivers/strong.py``; ref: strong/main.cpp:73-482,
strong/args.cpp:16-26; CLI -d global domain, -s subdomain, -I iterations,
-v validate).

One step: the strong exchange in place, then ``st_iter / fuse`` batched
sweeps over every subdomain of every rank of a card (kernel K1, one
launch per card), ghost-inclusive except the last.  The exchange is
``shift`` (per non-empty (stage, sign) a gather of the face rows and one
kernel K5 launch per card) or ``remote`` (per stage one kernel K10 launch
per card, the face rows pushed into the neighbouring rank's ghosts; on a
mesh whose every axis has one rank it is the staged exchange, as in the
reference).  Reported: GStencil/s and ms per step, the step statistics,
and the step's ratio to a copy of the same storage (kernel K3), as
``bench.py``'s strong leg reports it.

``backend="pencil"`` (``"auto"`` picks it) takes one of two layouts, as
the reference does.  Pencil subdomains (``sdom[2] == dom[2]`` on a mesh
whose i axis has one rank) keep the full global i extent in one brick,
so i stays periodic through the pencils and only k and j exchange.
Cubic subdomains (any other, upstream's strong study: 512^3 in 128^3)
keep the bricks as given with a ghost shell a whole brick deep on every
axis; the exchange runs over k, j and i (six faces, edges and corners
through the stages) and K1 sweeps the i-bricked table with ``i_ghost=1``,
the ghost-inclusive sweeps over its i ghost ring too (``i_range=(0,
GI)``).  The reference's default mesh is ``2,1,1``; here it is ``1,1,1``
so that the default runs on one card.  ``backend="jnp"`` runs the torch
oracle on any subdomain shape: bricks a whole brick deep in ghosts on
every axis, the strong exchange over all three axes, then ``st_iter``
ghost-inclusive iterations of one ``brick_apply`` over every subdomain of
every rank of a card (the reference's ``vmap``).  A mesh's ranks may share
a card (``devices=["cuda:0"] * 2``); without ``devices`` a mesh of
several ranks takes one card each.  :func:`build_step` opens the
program's ``bricklib.plan`` span (children ``.decomp``, ``.domain``: the
host draw of the global domain and every subdomain bricked, vectorised
per subdomain, and ``.kernels``) and each step a ``bricklib.step`` span
(its ordinal), as the weak driver does.  The
sweeps and the twin take ``bench_params()``: the reference driver's
``DEFAULT_PARAMS`` lacks the ``coeff`` group that ``s7pt`` reads, and on
every stencil it can run the two give the same coefficients.  ``--device``
defaults to ``cuda`` and raises where there is none: nothing falls back
to the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import trace
from ..bench.roofline import chain, copy_storage
from ..bench.timing import mpi_statistics, time_mpi
from ..codegen.jnp_backend import CardTables, dense_apply, oracle_iterate
from ..codegen.pencil_kernel import pencil_sweep
from ..codegen.schedule import StepSweeps, outer_ranges
from ..comm import skin3d_good
from ..comm.exchange import on_card
from ..comm.mesh import rank_views, run_mesh, to_state
from ..comm.strong import (StrongDecomp, strong_exchange,
                           strong_remote_exchange)
from ..core import compare_arrays, random_array
from ..core.setup import from_bricks as from_bricks_np
from ..core.setup import to_bricks
from ..stencils import bench_params, stencil_by_name
from .weak import mesh_label


def _check_supported(backend, exchange):
    if exchange not in ("shift", "remote"):
        raise ValueError("exchange is 'shift' (staged gather and copies) or "
                         "'remote' (one-kernel remote copies)")
    if backend not in ("auto", "pencil", "jnp"):
        raise ValueError(f"unknown backend {backend!r}")


def build_step(dom=(64, 64, 64), sdom=(32, 32, 32), bdim=(4, 4, 8),
               stencil="mpi7pt", st_iter=1, fuse=1, device="cuda",
               mesh_shape=(1, 1, 1), exchange="shift", devices=None,
               backend="pencil"):
    """``(step, storage, plan, g)``: the strong step (exchange in place on
    its argument, then the batched sweeps, or with ``backend="jnp"`` the
    oracle's iterations; returns the new storage), its
    storage, the plan, and the global domain ``g`` it was cut from (numpy,
    seed 4).  On a mesh of one rank the storage is its ``[nsub, nbricks,
    *bdim]`` stack; on a larger mesh it is the state, one ``[p, nsub,
    nbricks, *bdim]`` tensor per card (``step.mesh``).  Planned inside a
    ``bricklib.plan`` span."""
    with trace.span(trace.PLAN):
        return _plan_step(dom, sdom, bdim, stencil, st_iter, fuse, device,
                          mesh_shape, exchange, devices, backend)


def _plan_step(dom, sdom, bdim, stencil, st_iter, fuse, device, mesh_shape,
               exchange, devices, backend):
    mesh = run_mesh(mesh_shape, device, devices)
    sd = stencil_by_name(stencil)[0]
    lo, hi = sd.radius()
    rad = max(max(lo), max(hi))
    # the pencil backend's subdomains are cubic (i-bricked) unless each
    # keeps the whole global i extent on a mesh whose i axis has one rank
    # (ref: strong.py:41-42)
    cubic = backend != "jnp" and (int(sdom[2]) != int(dom[2])
                                  or int(mesh_shape[2]) != 1)
    if backend == "jnp" or cubic:
        # a whole brick of ghost on every axis (ref: strong.py:45-53)
        bdim = tuple(int(b) for b in bdim)
        gz = bdim
        # deep ghosts: every iteration spoils the ghost shell a radius
        # deeper on every axis, i included
        if cubic and st_iter * rad > min(bdim):
            raise ValueError("st_iter x radius exceeds ghost depth")
    else:
        bdim = (int(bdim[0]), int(bdim[1]), int(sdom[2]))
        gz = (bdim[0], bdim[1], 0)
        if st_iter * rad > min(bdim[0], bdim[1]):
            raise ValueError("st_iter x radius exceeds ghost depth")
    if backend != "jnp" and st_iter % fuse:
        raise ValueError("st_iter must be a multiple of fuse")
    with trace.span(trace.PLAN_DECOMP):
        plan = StrongDecomp(dom=dom, sdom=sdom, mesh_shape=tuple(mesh_shape),
                            bdims=bdim, ghost_depth=gz).initialize(
                                skin3d_good)
    sdec = plan.sdec
    nloc, nb = plan.nsub_local, sdec.nbricks
    with trace.span(trace.PLAN_DOMAIN):
        g = random_array(tuple(dom), np.float32, seed=4)
        arrays = []
        for r in range(mesh.size):
            c = mesh.coords_of(r)
            stacked = np.zeros((nloc, nb) + bdim, np.float32)
            for row in range(nloc):
                base = [c[a] * plan.local_block[a] + plan.sub_order[row][a]
                        for a in range(3)]
                idx = [(np.arange(base[a] * sdom[a] - gz[a],
                                  (base[a] + 1) * sdom[a] + gz[a]) % dom[a])
                       for a in range(3)]
                dat = stacked[row].reshape(nb, -1)
                to_bricks(g[np.ix_(*idx)], sdec.grid, bdim, dat=dat)
                dat[sdec.sep_pos[1]:] = 0
            arrays.append(stacked)
        state = to_state(mesh, arrays)
        del arrays
    calls = {"step": 0}
    exchange_fn = (strong_remote_exchange(plan, mesh) if exchange == "remote"
                   else strong_exchange(plan, mesh=mesh))
    if backend == "jnp":
        step_state = _oracle_step(sd, plan, bdim, st_iter, exchange_fn,
                                  calls)
        return (_finish(step_state, mesh, exchange_fn, None),
                _storage(state, mesh), plan, g)

    if cubic:
        # i-bricked sweeps over the decomposition's own table (ref:
        # strong.py:94-110): the i ghost ring skipped, or swept too
        grid = sdec.grid
        i_kw = {False: dict(i_ghost=1),
                True: dict(i_ghost=1, i_range=(0, grid.shape[2]))}
    else:
        grid = sdec.periodic_grid((2,))
        i_kw = {False: {}, True: {}}

    def make(p, ghost):
        return pencil_sweep(sd, grid, bdim, p * nloc * nb, bench_params(),
                            **outer_ranges(grid, (), ghost),
                            **i_kw[ghost], fuse=fuse, batch=p * nloc,
                            batch_stride=nb)

    sweeps = StepSweeps(make, st_iter // fuse, True)

    def step_state(state):
        calls["step"] += 1
        with trace.span(trace.STEP, step=calls["step"]):
            exchange_fn(state)
            return sweeps(state)

    step = _finish(step_state, mesh, exchange_fn,
                   sweeps.pair(len(mesh.ranks_on(0)))[::-1])
    return step, _storage(state, mesh), plan, g


def _oracle_step(sd, plan, bdim, st_iter, exchange_fn, calls):
    """The oracle's step over a state (ref: strong.py:139-143): the
    exchange in place, then ``st_iter`` ghost-inclusive ``brick_apply``
    iterations, one per card over every subdomain of its ranks (the
    adjacency offset per subdomain, uploaded once per card)."""
    gname = next(iter(sd.inputs))
    tables = CardTables(plan.sdec.nbricks, adj=plan.sdec.info.adj)

    def step_state(state):
        calls["step"] += 1
        with trace.span(trace.STEP, step=calls["step"]):
            exchange_fn(state)
            out = []
            for t in state:
                adj = tables(t.device, t.shape[0] * t.shape[1])["adj"]
                with on_card(t.device):
                    (v,) = oracle_iterate((sd,), (gname,),
                                          (t.view((-1,) + bdim),), adj,
                                          bench_params(), st_iter)
                out.append(v.view(t.shape))
            return out

    return step_state


def _storage(state, mesh):
    """The state on a mesh of several ranks; one rank's stack otherwise."""
    return state if mesh.size > 1 else state[0][0]


def _finish(step_state, mesh, exchange_fn, sweeps):
    """The step over the storage :func:`_storage` gives, carrying its
    ``exchange``, ``sweeps`` (the pencil sweeps, skip then ghost) and
    ``mesh``."""
    if mesh.size > 1:
        step = step_state
    else:
        def step(x):
            """Exchange (in place on ``x``) then the step's iterations."""
            return step_state([x.unsqueeze(0)])[0][0]
    step.exchange = exchange_fn
    step.sweeps = sweeps
    step.mesh = mesh
    return step


def validate_step(step, storage, plan, g, stencil, st_iter,
                  mesh=None) -> bool:
    """One step against the global dense numpy twin at 1e-4 on every
    subdomain of every rank (ref: drivers/strong.py:152-176).  ``mesh``:
    the mesh of a state; without it ``storage`` is one rank's stack."""
    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    if mesh is None:
        outs, coords = [step(storage.clone())], [(0, 0, 0)]
    else:
        outs = rank_views(mesh, step([t.clone() for t in storage]))
        coords = [mesh.coords_of(r) for r in range(mesh.size)]
    b = g
    for _ in range(st_iter):
        gp = np.pad(b, list(zip(lo, hi)), mode="wrap")
        b = dense_apply(sd, {gname: gp}, bench_params(), xp=np)
    sdom, nb = plan.sdom, plan.sdec.nbricks
    for out, c in zip(outs, coords):
        out = out.cpu().numpy()
        for row in range(plan.nsub_local):
            base = [c[a] * plan.local_block[a] + plan.sub_order[row][a]
                    for a in range(3)]
            sl = tuple(slice(base[a] * sdom[a], (base[a] + 1) * sdom[a])
                       for a in range(3))
            got = from_bricks_np(out[row].reshape(nb, -1),
                                 plan.sdec.interior_grid(), plan.bdims)
            if not compare_arrays(got, b[sl], 1e-4):
                return False
    return True


def run(dom=(64, 64, 64), sdom=(32, 32, 32), bdim=(4, 4, 8),
        stencil="mpi7pt", st_iter=1, mesh_shape=(1, 1, 1), iters=25,
        validate=False, backend="auto", fuse=1, exchange="shift",
        device="cuda", devices=None):
    """Build, validate and time the strong step on ``mesh_shape`` ranks
    (``devices``: one per rank, repeats allowed).  Returns a dict of
    seconds (``step``, ``copy``), the rates, the number of calls made of
    each timed function (``calls``; ``copy`` counts one per card) and the
    exchange's kernel launches per step (``exchange_launches``)."""
    dom, sdom = tuple(int(d) for d in dom), tuple(int(d) for d in sdom)
    mesh_shape = tuple(int(m) for m in mesh_shape)
    _check_supported(backend, exchange)
    backend = "pencil" if backend == "auto" else backend
    step, storage, plan, g = build_step(dom, sdom, bdim, stencil, st_iter,
                                        fuse, device, mesh_shape, exchange,
                                        devices, backend)
    mesh = step.mesh
    state = storage if mesh.size > 1 else [storage.unsqueeze(0)]
    calls = {"step": 0, "copy": 0}

    def counted_step(x):
        calls["step"] += 1
        return step(x)

    if validate:
        if not validate_step(counted_step, storage, plan, g, stencil,
                             st_iter, mesh if mesh.size > 1 else None):
            raise RuntimeError("validation mismatch vs global dense twin")
        print("validated against global dense twin: OK")

    avg, samples = time_mpi(counted_step, [t.clone() for t in state]
                            if mesh.size > 1 else storage.clone(),
                            iters=iters)

    def counted_copy(x):
        calls["copy"] += len(x)
        out = []
        for t in x:
            with on_card(t.device):
                out.append(copy_storage(t))
        return out

    t_copy, _ = chain(counted_copy, state, iters)
    nloc = plan.nsub_local
    elems = int(np.prod(dom)) * st_iter
    gst = elems / avg / 1e9
    store_bytes = sum(t.numel() * t.element_size() for t in state)
    copy_bw = 2 * store_bytes / t_copy
    vs_copy = st_iter * t_copy / avg
    ex = step.exchange
    launches = (sum(1 for per_card in ex.plan for rows in per_card if rows)
                if hasattr(ex, "plan")
                else len(ex.stages) * len(mesh.cards))
    label = mesh_label(mesh)
    print(f"device {label}")
    print(f"dom {dom} sdom {sdom} mesh {mesh_shape} "
          f"subs/rank {nloc} stencil {stencil} backend {backend} "
          f"ST_ITER {st_iter}"
          + (f" fuse {fuse}" if backend == "pencil" else "")
          + f" exchange {exchange}")
    print(f"perf {gst:8.3f} GStencil/s ({avg * 1e3:.3f} ms/step)")
    print(f"copy roofline {copy_bw / 1e9:.1f} GB/s ({t_copy * 1e3:.3f} "
          f"ms/copy of {store_bytes / 1e6:.1f} MB); step at {vs_copy:.3f} "
          f"of the copy speed of light per iteration")
    st = mpi_statistics(samples)
    print(f"  step min {st['min']*1e3:7.3f} avg {st['avg']*1e3:7.3f} "
          f"max {st['max']*1e3:7.3f} sigma {st['sigma']*1e3:7.3f} ms")
    return {"step": avg, "copy": t_copy, "copy_gbs": copy_bw / 1e9,
            "gstencil_s": gst, "vs_copy_sol": vs_copy, "calls": dict(calls),
            "exchange_steps": len(ex.stages), "exchange_launches": launches,
            "device": label, "ranks": mesh.size, "cards": len(mesh.cards)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-d", "--dom", default="64,64,64")
    p.add_argument("-s", "--sdom", default="32,32,32")
    p.add_argument("-b", "--bdim", default="4,4,8")
    p.add_argument("--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=1)
    p.add_argument("--mesh", default="1,1,1",
                   help="ranks per axis (more than one in i: cubic "
                        "subdomains)")
    p.add_argument("--devices", default=None,
                   help="one device per rank, comma-separated, repeats "
                        "allowed; default: one card per rank")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("-v", "--validate", action="store_true")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pencil"],
                   help="pencil: batched sweeps of kernel K1, pencil or "
                        "cubic subdomains (auto picks it); jnp: the torch "
                        "oracle, any subdomain shape")
    p.add_argument("--fuse", type=int, default=1,
                   help="iterations fused per pass over device memory")
    p.add_argument("--exchange", default="shift",
                   choices=["shift", "remote"],
                   help="staged gather and K5, or remote copies (K10); on "
                        "mesh 1,1,1 both are the staged exchange")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises when there is "
                        "no card")
    a = p.parse_args(argv)
    run(tuple(int(x) for x in a.dom.split(",")),
        tuple(int(x) for x in a.sdom.split(",")),
        tuple(int(x) for x in a.bdim.split(",")),
        a.stencil, a.st_iter,
        tuple(int(x) for x in a.mesh.split(",")),
        a.iters, a.validate, a.backend, a.fuse, a.exchange, a.device,
        a.devices and a.devices.split(","))


if __name__ == "__main__":
    main()
