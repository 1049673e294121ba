"""Weak-scaling driver on PyTorch: ghost exchange + fused pencil sweeps,
validated against the dense numpy twin (port of
``bricklib_tpu/drivers/weak.py``; ref: weak/main.cpp:38-306 and
weak/main-4d.cpp for 4-D domains).

One step is the reference's honest distributed configuration on one
device: one SHIFT exchange that moves real ghost bricks (in-place
self-copies, kernel K2), then ``st_iter / fuse`` pencil sweeps (kernel K1
on a 3-D domain, K4 on a 4-D one), ghost-inclusive except the last.
Reported: GStencil/s and ms per step, the marginal exchange share, the
phase statistics, and the step's ratio to the copy speed of light (kernel
K3).

The port runs ``backend="pencil"``, ``exchange="shift"`` on a mesh of one
device per axis (the default), for 3-D and 4-D domains;
the reference's other modes raise ``NotImplementedError`` naming the
ROADMAP.md item that brings them.  ``--device`` defaults to ``cuda`` and
raises where there is none: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from bricklib_tpu.codegen.jnp_backend import dense_apply
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.core import compare_arrays, random_array, to_bricks
from bricklib_tpu.core import from_bricks as from_bricks_np
from bricklib_tpu.stencils import bench_params, stencil_by_name

from ..bench.roofline import chain, make_dma_copy
from ..bench.timing import mpi_statistics, time_mpi
from ..codegen.pencil_kernel import pencil_sweep
from ..codegen.pencil_kernel_4d import pencil_sweep_4d
from ..comm.exchange import MULTI_GPU_ITEM, shift_exchange
from ..core import not_ported, require_device


@dataclass
class WeakStep:
    """A built step: ``step(d)`` (exchange + sweeps) and ``step_noex(d)``
    (the sweeps alone) on ``storage``; ``calls`` counts their calls."""

    step: object
    step_noex: object
    storage: torch.Tensor
    dec: BrickDecomp
    block: np.ndarray
    bdim: tuple
    gz: tuple
    moves_data: bool
    calls: dict


def _check_supported(dims, mesh_shape, backend, exchange, overlap,
                     profile_dir, f64_validate):
    if backend != "pencil":
        raise not_ported(f"--backend {backend}", "the torch oracle "
                         "(dense_apply/brick_apply)")
    if exchange != "shift":
        raise not_ported(f"--exchange {exchange}", "kernel-level exchanges"
                         if exchange in ("shift-remote", "fused")
                         else MULTI_GPU_ITEM)
    if overlap:
        raise not_ported("--overlap", "remaining pencil_sweep features "
                         "(inplace)")
    if profile_dir:
        raise not_ported("--profile", "the rest (tracing)")
    if f64_validate:
        raise not_ported("--f64-validate", "the torch oracle "
                         "(dense_apply/brick_apply)")
    if tuple(mesh_shape) != (1,) * len(dims):
        raise not_ported(f"--mesh {mesh_shape}", MULTI_GPU_ITEM)
    if len(dims) not in (3, 4):
        raise not_ported(f"{len(dims)}-D domains", "ranks 2/4 (the 2-D "
                         "sweep)")


def _make_step(dims, bdim, stencil, st_iter, fuse, table_periodic, skin,
               device, quiet=False) -> WeakStep:
    nd = len(dims)
    mesh_shape = (1,) * nd
    dev = require_device(device)
    sd = stencil_by_name(stencil)[0]
    lo_r, hi_r = sd.radius()
    rad = max(max(lo_r), max(hi_r))
    bdim = tuple(int(b) for b in bdim[:nd - 1]) + (int(dims[-1]),)
    gz = bdim[:nd - 1] + (0,)
    # deep-ghost ST_ITER bound (ref: weak/main.cpp:203-212)
    if not table_periodic and st_iter * rad > min(bdim[:nd - 1]):
        raise ValueError(f"st_iter {st_iter} x radius {rad} exceeds ghost "
                         f"depth {min(bdim[:nd - 1])}")
    if st_iter % fuse:
        raise ValueError("st_iter must be a multiple of fuse")
    dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=bdim).initialize(
        skinlist_by_name(skin, nd))
    if not quiet:
        print(f"skin ordering '{skin}': {len(dec.ghost)} ghost runs "
              f"(PUT messages), {len(dec.sections)} sections")
    # the periodic domain with its ghost shell, as on one device of the
    # reference's mesh
    g = random_array(tuple(dims), np.float32, seed=3)
    idx = [np.arange(-gz[a], dims[a] + gz[a]) % dims[a] for a in range(nd)]
    block = g[np.ix_(*idx)]
    dat = np.zeros((dec.nbricks, int(np.prod(bdim))), np.float32)
    to_bricks(block, dec.grid, bdim, dat=dat)
    dat[dec.sep_pos[1]:] = 0
    storage = torch.from_numpy(dat.reshape((-1,) + bdim)).to(dev)

    params = bench_params()
    # undistributed axes go through the table (zero-copy periodicity);
    # the i axis never exchanges: pencil rolls are periodic in i
    table_axes = tuple(a for a in range(nd)
                       if mesh_shape[a] == 1
                       and (table_periodic or a == nd - 1))
    kgrid = dec.periodic_grid(table_axes)

    def _ranges(skip):
        return {f"{'wkj'[a + 4 - nd]}_range": (1, kgrid.shape[a] - 1)
                if a in table_axes else (skip, kgrid.shape[a] - skip)
                for a in range(nd - 1)}

    sweep = pencil_sweep if nd == 3 else pencil_sweep_4d
    fkw = dict(fuse=fuse) if fuse > 1 else dict(lookahead=2)
    pencil_fn = sweep(sd, kgrid, bdim, dec.nbricks, params, **_ranges(1),
                      **fkw)
    pencil_ghost_fn = None
    if st_iter > fuse and len(table_axes) < nd:
        pencil_ghost_fn = sweep(sd, kgrid, bdim, dec.nbricks, params,
                                **_ranges(0), **fkw)
    moves_data = len(table_axes) < nd
    exchange = shift_exchange(dec, mesh_shape, table_axes) \
        if moves_data else None
    nsweeps = st_iter // fuse
    calls = {"step": 0, "step_noex": 0}

    def sweeps(d):
        for it in range(nsweeps):
            last = it == nsweeps - 1
            d = pencil_fn(d) if (last or pencil_ghost_fn is None) \
                else pencil_ghost_fn(d)
        return d

    def step(d):
        """Exchange (in place on ``d``) then the sweeps."""
        calls["step"] += 1
        if exchange is not None:
            d = exchange(d)
        return sweeps(d)

    def step_noex(d):
        """The step without its exchange: the exchange cost is measured
        differentially (step - step_noex)."""
        calls["step_noex"] += 1
        return sweeps(d)

    return WeakStep(step, step_noex, storage, dec, block, bdim, gz,
                    moves_data, calls)


def build_step(dims=(64, 64, 64), bdim=(8, 8, 128), stencil="mpi7pt",
               st_iter=8, fuse=1, table_periodic=True, skin="good",
               device="cuda"):
    """``(step_fn, storage, dec)`` of the pencil step, for holding it
    against the reference.  ``step_fn`` updates its argument in place
    (the exchange) and returns the new storage."""
    s = _make_step(tuple(dims), bdim, stencil, st_iter, fuse,
                   table_periodic, skin, device, quiet=True)
    return s.step, s.storage, s.dec


def validate_step(s: WeakStep, stencil: str, st_iter: int) -> bool:
    """One step against the dense numpy twin at 1e-4 on the owned region
    that st_iter halo sweeps leave exact (ref: weak.py:324-348).  The twin
    takes the coefficients the sweeps took (``bench_params()``)."""
    sd = stencil_by_name(stencil)[0]
    gname = next(iter(sd.inputs))
    out = s.step(s.storage.clone()).cpu().numpy()
    lo, hi = sd.radius()
    dims = s.dec.dims
    b = s.block
    for _ in range(st_iter):
        nxt = dense_apply(sd, {gname: b}, bench_params(), xp=np)
        b2 = np.zeros_like(b)
        b2[tuple(slice(l, n - h) for l, n, h in zip(lo, b.shape, hi))] = nxt
        b = b2
    nd = len(dims)
    own = tuple(slice(s.gz[a], s.gz[a] + dims[a]) for a in range(nd))
    got = from_bricks_np(out.reshape(s.dec.nbricks, -1),
                         s.dec.interior_grid(), s.bdim)
    m = [max(st_iter * max(l, h) - s.gz[a], 0)
         for a, (l, h) in enumerate(zip(lo, hi))]
    sl = tuple(slice(m[a], dims[a] - m[a]) for a in range(nd))
    return compare_arrays(got[sl], b[own][sl], 1e-4)


def device_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (cuda)"
    return "cpu"


def run(dims=(64, 64, 64), bdim=(8, 8, 128), stencil="mpi7pt",
        st_iter=8, mesh_shape=None, iters=25, validate=True,
        overlap=False, backend="pencil", profile_dir=None,
        exchange="shift", table_periodic=True, skin="good",
        f64_validate=False, fuse=1, device="cuda"):
    """Build, validate and time the weak step.  Returns a dict of seconds
    (``step``, ``exchange``, ``copy``, ``phases``) and the number of
    calls made of each timed function (``calls``)."""
    dims = tuple(int(d) for d in dims)
    if mesh_shape is None:
        mesh_shape = (1,) * len(dims)
    _check_supported(dims, mesh_shape, backend, exchange, overlap,
                     profile_dir, f64_validate)
    s = _make_step(dims, bdim, stencil, st_iter, fuse, table_periodic,
                   skin, device)
    dev = s.storage.device
    if validate:
        if not validate_step(s, stencil, st_iter):
            raise RuntimeError("validation mismatch vs array twin")
        print("validated against array twin: OK")

    avg, samples = time_mpi(s.step, s.storage.clone(), iters=iters)
    if s.moves_data:
        avg_nx, samples_x = time_mpi(s.step_noex, s.storage.clone(),
                                     iters=iters)
        avg_x = max(avg - avg_nx, 0.0)
    else:
        avg_x, samples_x = 0.0, [0.0]
    # the copy speed of light of the same storage (bench.py:391-402)
    copy_fn = make_dma_copy(s.dec.nbricks, s.bdim)
    n_copy = [0]

    def counted_copy(v):
        n_copy[0] += 1
        return copy_fn(v)

    t_copy, _ = chain(counted_copy, s.storage, iters)
    s.calls["copy"] = n_copy[0]

    elems = int(np.prod(dims)) * st_iter
    ghost_bytes = (s.dec.nbricks - s.dec.sep_pos[1]) * int(
        np.prod(s.bdim)) * 4
    store_bytes = s.storage.numel() * s.storage.element_size()
    copy_bw = 2 * store_bytes / t_copy
    sol_gst = 2 * elems / st_iter * 4 / t_copy / (2 * 4) / 1e9
    gst = elems / avg / 1e9
    print(f"device {device_label(dev)}")
    print(f"domain {dims} mesh {(1,) * len(dims)} stencil {stencil} "
          f"ST_ITER {st_iter} fuse {fuse}")
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
    return {"step": avg, "exchange": avg_x, "copy": t_copy,
            "copy_gbs": copy_bw / 1e9, "phases": phases,
            "gstencil_s": gst, "vs_copy_sol": gst / sol_gst,
            "calls": dict(s.calls), "device": device_label(dev)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-d", "--dims", default="64,64,64",
                   help="per-device domain")
    p.add_argument("-b", "--bdim", default="8,8,8")
    p.add_argument("-s", "--stencil", default="mpi7pt")
    p.add_argument("-I", "--st-iter", type=int, default=8)
    p.add_argument("--mesh", default=None,
                   help="devices per axis (default: one per axis)")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--overlap", action="store_true",
                   help="interior/boundary split (not ported)")
    p.add_argument("--backend", default="pencil", choices=["jnp", "pencil"],
                   help="only pencil is ported")
    p.add_argument("--profile", dest="profile_dir", default=None,
                   help="trace directory (not ported)")
    p.add_argument("--exchange", default="shift",
                   choices=["shift", "put", "shift-remote", "fused"],
                   help="only shift is ported")
    p.add_argument("--no-table-periodic", action="store_true",
                   help="exchange real ghost bricks even on 1-device "
                        "axes (honest distributed config)")
    p.add_argument("--skin", default="good",
                   choices=["good", "normal", "bad", "lex"])
    p.add_argument("--f64-validate", action="store_true",
                   help="float64 validation (not ported)")
    p.add_argument("--fuse", type=int, default=1,
                   help="stencil iterations fused per pass over device "
                        "memory (must divide st_iter)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the step runs; cuda raises when there is "
                        "no card")
    a = p.parse_args(argv)
    run(tuple(int(x) for x in a.dims.split(",")),
        tuple(int(x) for x in a.bdim.split(",")),
        a.stencil, a.st_iter,
        a.mesh and tuple(int(x) for x in a.mesh.split(",")),
        a.iters, validate=not a.no_validate, overlap=a.overlap,
        backend=a.backend, profile_dir=a.profile_dir,
        exchange=a.exchange, table_periodic=not a.no_table_periodic,
        skin=a.skin, f64_validate=a.f64_validate, fuse=a.fuse,
        device=a.device)


if __name__ == "__main__":
    main()
