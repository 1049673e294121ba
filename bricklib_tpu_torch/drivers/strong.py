"""Strong-scaling driver on PyTorch: a fixed global domain as a stack of
Morton-ordered subdomains, exchanged and swept in batches, validated
against the global dense numpy twin (port of
``bricklib_tpu/drivers/strong.py``; ref: strong/main.cpp:73-482,
strong/args.cpp:16-26; CLI -d global domain, -s subdomain, -I iterations,
-v validate).

One step on one device: the strong SHIFT exchange in place (a gather of
the face rows, then kernel K5 once per non-empty (stage, sign)), then
``st_iter / fuse`` batched pencil sweeps over every subdomain of the stack
(kernel K1), ghost-inclusive except the last.  Subdomains keep the full
global i extent, so i stays periodic through the pencils and only k and j
exchange.  Reported: GStencil/s and ms per step, the step statistics, and
the step's ratio to a copy of the same storage (kernel K3), as
``bench.py``'s strong leg reports it.

The port runs ``backend="pencil"`` (``"auto"`` picks it) with pencil
subdomains on mesh 1,1,1; ``--exchange remote`` there is the same staged
exchange, as in the reference.  The sweeps and the twin take
``bench_params()``: the reference driver's ``DEFAULT_PARAMS`` lacks the
``coeff`` group that ``s7pt`` reads, and on every stencil it can run the
two give the same coefficients.  ``--device`` defaults to ``cuda`` and
raises where there is none: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bricklib_tpu.codegen.jnp_backend import dense_apply
from bricklib_tpu.comm import skin3d_good
from bricklib_tpu.core import compare_arrays, random_array, to_bricks
from bricklib_tpu.core import from_bricks as from_bricks_np
from bricklib_tpu.stencils import bench_params, stencil_by_name

from ..bench.roofline import chain, make_dma_copy
from ..bench.timing import mpi_statistics, time_mpi
from ..codegen.pencil_kernel import FEATURES_ITEM, pencil_sweep
from ..comm.exchange import MULTI_GPU_ITEM
from ..comm.strong import StrongDecomp, strong_exchange
from ..core import not_ported, require_device
from .weak import device_label


def _check_supported(dom, sdom, mesh_shape, backend, exchange):
    if exchange not in ("shift", "remote"):
        raise ValueError("exchange is 'shift' (staged ppermute) or "
                         "'remote' (one-kernel remote DMAs)")
    if backend == "jnp":
        raise not_ported("--backend jnp", "the torch oracle "
                         "(dense_apply/brick_apply)")
    if backend not in ("auto", "pencil"):
        raise ValueError(f"unknown backend {backend!r}")
    if any(m > 1 for m in mesh_shape):
        raise not_ported(f"--mesh {tuple(mesh_shape)}", MULTI_GPU_ITEM)
    if sdom[2] != dom[2]:
        raise not_ported("cubic strong subdomains (i-bricked sweeps)",
                         FEATURES_ITEM)


def build_step(dom=(64, 64, 64), sdom=(32, 32, 64), bdim=(4, 4, 8),
               stencil="mpi7pt", st_iter=1, fuse=1, device="cuda"):
    """``(step, storage, plan, g)``: the strong step (exchange in place on
    its argument, then the batched sweeps; returns the new stack), its
    ``[nsub, nbricks, *bdim]`` storage, the plan, and the global domain
    ``g`` it was cut from (numpy, seed 4)."""
    dev = require_device(device)
    sd = stencil_by_name(stencil)[0]
    lo, hi = sd.radius()
    rad = max(max(lo), max(hi))
    bdim = (int(bdim[0]), int(bdim[1]), int(sdom[2]))
    gz = (bdim[0], bdim[1], 0)
    if st_iter * rad > min(bdim[0], bdim[1]):
        raise ValueError("st_iter x radius exceeds ghost depth")
    if st_iter % fuse:
        raise ValueError("st_iter must be a multiple of fuse")
    plan = StrongDecomp(dom=dom, sdom=sdom, mesh_shape=(1, 1, 1),
                        bdims=bdim, ghost_depth=gz).initialize(skin3d_good)
    sdec = plan.sdec
    nloc, nb = plan.nsub_local, sdec.nbricks
    g = random_array(tuple(dom), np.float32, seed=4)
    stacked = np.zeros((nloc, nb) + bdim, np.float32)
    for row in range(nloc):
        lc = plan.sub_order[row]
        idx = [(np.arange(lc[a] * sdom[a] - gz[a],
                          lc[a] * sdom[a] + sdom[a] + gz[a]) % dom[a])
               for a in range(3)]
        dat = np.zeros((nb, int(np.prod(bdim))), np.float32)
        to_bricks(g[np.ix_(*idx)], sdec.grid, bdim, dat=dat)
        dat[sdec.sep_pos[1]:] = 0
        stacked[row] = dat.reshape((nb,) + bdim)
    storage = torch.from_numpy(stacked).to(dev)

    kgrid = sdec.periodic_grid((2,))
    GKs, GJs = kgrid.shape[0], kgrid.shape[1]
    fkw = dict(fuse=fuse) if fuse > 1 else {}
    common = dict(batch=nloc, batch_stride=nb, **fkw)
    sweep_skip = pencil_sweep(sd, kgrid, bdim, nloc * nb, bench_params(),
                              **common)
    sweep_ghost = None
    if st_iter > fuse:
        sweep_ghost = pencil_sweep(sd, kgrid, bdim, nloc * nb,
                                   bench_params(), k_range=(0, GKs),
                                   j_range=(0, GJs), **common)
    exchange = strong_exchange(plan)
    nsweeps = st_iter // fuse

    def step(x):
        """Exchange (in place on ``x``) then the batched sweeps."""
        x = exchange(x)
        flat = x.view((nloc * nb,) + bdim)
        for it in range(nsweeps):
            last = it == nsweeps - 1
            flat = (sweep_skip if (last or sweep_ghost is None)
                    else sweep_ghost)(flat)
        return flat.view(x.shape)

    step.exchange = exchange
    step.sweeps = (sweep_ghost, sweep_skip)
    return step, storage, plan, g


def validate_step(step, storage, plan, g, stencil, st_iter) -> bool:
    """One step against the global dense numpy twin at 1e-4 on every
    subdomain (ref: drivers/strong.py:152-176)."""
    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    lo, hi = sd.radius()
    out = step(storage.clone()).cpu().numpy()
    b = g
    for _ in range(st_iter):
        gp = np.pad(b, list(zip(lo, hi)), mode="wrap")
        b = dense_apply(sd, {gname: gp}, bench_params(), xp=np)
    sdom, nb = plan.sdom, plan.sdec.nbricks
    for row in range(plan.nsub_local):
        lc = plan.sub_order[row]
        sl = tuple(slice(lc[a] * sdom[a], (lc[a] + 1) * sdom[a])
                   for a in range(3))
        got = from_bricks_np(out[row].reshape(nb, -1),
                             plan.sdec.interior_grid(), plan.bdims)
        if not compare_arrays(got, b[sl], 1e-4):
            return False
    return True


def run(dom=(64, 64, 64), sdom=(32, 32, 64), bdim=(4, 4, 8),
        stencil="mpi7pt", st_iter=1, mesh_shape=(1, 1, 1), iters=25,
        validate=False, backend="auto", fuse=1, exchange="shift",
        device="cuda"):
    """Build, validate and time the strong step.  Returns a dict of
    seconds (``step``, ``copy``), the rates, and the number of calls made
    of each timed function (``calls``)."""
    dom, sdom = tuple(int(d) for d in dom), tuple(int(d) for d in sdom)
    _check_supported(dom, sdom, tuple(mesh_shape), backend, exchange)
    step, storage, plan, g = build_step(dom, sdom, bdim, stencil, st_iter,
                                        fuse, device)
    calls = {"step": 0, "copy": 0}

    def counted_step(x):
        calls["step"] += 1
        return step(x)

    if validate:
        if not validate_step(counted_step, storage, plan, g, stencil,
                             st_iter):
            raise RuntimeError("validation mismatch vs global dense twin")
        print("validated against global dense twin: OK")

    avg, samples = time_mpi(counted_step, storage.clone(), iters=iters)
    nloc, nb = plan.nsub_local, plan.sdec.nbricks
    flat = storage.view((nloc * nb,) + tuple(plan.bdims))
    copy_fn = make_dma_copy(nloc * nb, plan.bdims)

    def counted_copy(v):
        calls["copy"] += 1
        return copy_fn(v)

    t_copy, _ = chain(counted_copy, flat, iters)
    elems = int(np.prod(dom)) * st_iter
    gst = elems / avg / 1e9
    store_bytes = storage.numel() * storage.element_size()
    copy_bw = 2 * store_bytes / t_copy
    vs_copy = st_iter * t_copy / avg
    print(f"device {device_label(storage.device)}")
    print(f"dom {dom} sdom {sdom} mesh {tuple(mesh_shape)} "
          f"subs/device {nloc} stencil {stencil} backend pencil "
          f"ST_ITER {st_iter} fuse {fuse}")
    print(f"perf {gst:8.3f} GStencil/s ({avg * 1e3:.3f} ms/step)")
    print(f"copy roofline {copy_bw / 1e9:.1f} GB/s ({t_copy * 1e3:.3f} "
          f"ms/copy of {store_bytes / 1e6:.1f} MB); step at {vs_copy:.3f} "
          f"of the copy speed of light per iteration")
    st = mpi_statistics(samples)
    print(f"  step min {st['min']*1e3:7.3f} avg {st['avg']*1e3:7.3f} "
          f"max {st['max']*1e3:7.3f} sigma {st['sigma']*1e3:7.3f} ms")
    return {"step": avg, "copy": t_copy, "copy_gbs": copy_bw / 1e9,
            "gstencil_s": gst, "vs_copy_sol": vs_copy, "calls": dict(calls),
            "exchange_steps": len(step.exchange.stages),
            "device": device_label(storage.device)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-d", "--dom", default="64,64,64")
    p.add_argument("-s", "--sdom", default="32,32,64")
    p.add_argument("-b", "--bdim", default="4,4,8")
    p.add_argument("--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=1)
    p.add_argument("--mesh", default="1,1,1")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("-v", "--validate", action="store_true")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pencil"],
                   help="only pencil is ported (auto picks it)")
    p.add_argument("--fuse", type=int, default=1,
                   help="iterations fused per pass over device memory")
    p.add_argument("--exchange", default="shift",
                   choices=["shift", "remote"],
                   help="on mesh 1,1,1 both are the staged exchange")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises when there is "
                        "no card")
    a = p.parse_args(argv)
    run(tuple(int(x) for x in a.dom.split(",")),
        tuple(int(x) for x in a.sdom.split(",")),
        tuple(int(x) for x in a.bdim.split(",")),
        a.stencil, a.st_iter,
        tuple(int(x) for x in a.mesh.split(",")),
        a.iters, a.validate, a.backend, a.fuse, a.exchange, a.device)


if __name__ == "__main__":
    main()
