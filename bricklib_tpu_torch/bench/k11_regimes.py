"""Kernel K11 in every regime its main paths run, timed on the card.

    python -m bricklib_tpu_torch.bench.k11_regimes [--parent DIR] [--pairs N]

K11 is the PUT exchange fused into the ghost-inclusive ``fuse=1`` sweep
(``codegen/fused_exchange.py``), one launch per card and step.  Each
regime runs it on mesh (2, 2, 1), the four ranks on one card, i through
the table, as the weak step does: the full weak mesh plan (512^3 per
rank, bricks (8, 8, 512), ``s7pt``: 1,040 copy chunks of 128 KiB), and
at 128^3 per rank ``mpi125pt`` (K1's compiled cube) and ``s27pt`` (K1's
generic body), and ``s7pt`` with ghosts two bricks deep.  Each is timed
with CUDA events over ``--iters`` launches after one warm-up, and digested
(sha256 of every card's output on the bricks it writes and of the
exchanged storage), from storage made from one seed.  Beside the full
plan, in the same process: the composition K11 replaces (the PUT exchange
then the ghost-inclusive K1 over the four ranks), each of its two parts
alone, and the weak mesh step at ``fuse=1`` (``ST_ITER`` 8, 25 steps
after one) with ``--exchange fused`` (K11 and seven batched K1) and
``put`` (the PUT exchange and eight).

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of each
regime per tree are printed, and whether every run of both trees gave the
same digest.  The full plan's bound is printed first (the sweep's bricks
read and written once, the copied rows read and written once).  The last
line is one JSON object of the results, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

N, BD, MESH = 512, (8, 8, 512), (2, 2, 1)
SMALL = 128


def case(n: int, stencil: str, rings: int = 1, seed: int = 5):
    """``(fused fn, PUT exchange, K1 over the four ranks, state, dec)`` on
    mesh (2, 2, 1), ranks on cuda:0, ``n``^3 per rank with bricks (8, 8,
    n)."""
    import torch

    from bricklib_tpu_torch.codegen.fused_exchange import pencil_sweep_fusedx
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import put_exchange, put_plan
    from bricklib_tpu_torch.comm.mesh import make_domain_mesh
    from bricklib_tpu_torch.stencils import bench_params

    bd = (8, 8, n)
    dec = BrickDecomp(dims=(n,) * 3, ghost_depth=(8 * rings, 8 * rings, 0),
                      bdims=bd).initialize(skinlist_by_name("good", 3))
    mesh = make_domain_mesh(MESH, devices=["cuda:0"] * 4)
    grid = dec.periodic_grid((2,))
    fn = pencil_sweep_fusedx(stencil, grid, bd, dec.nbricks,
                             put_plan(dec, MESH, (2,)), MESH, bench_params(),
                             mesh=mesh)
    kr, jr = fn.plan.ranges
    k1 = pencil_sweep(stencil, grid, bd, 4 * dec.nbricks, bench_params(),
                      k_range=kr, j_range=jr, batch=4,
                      batch_stride=dec.nbricks)
    g = torch.Generator("cuda").manual_seed(seed)
    state = [torch.rand((4, dec.nbricks) + bd, device="cuda", generator=g)]
    return fn, put_exchange(dec, mesh, (2,)), k1, state, dec


def digest(fn, state) -> str:
    """sha256 of K11's output on the bricks it writes and of the exchanged
    storage, from a copy of ``state``."""
    import torch

    s = [t.clone() for t in state]
    outs, _ = fn(s)
    w = torch.from_numpy(fn.plan.written_bricks()).to(s[0].device)
    h = hashlib.sha256()
    for o, t in zip(outs, s):
        h.update(o[:, w].cpu().numpy().tobytes())
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def bounds() -> dict:
    """The full plan's bound: the batched sweep's bricks read and written
    once (``roofline.sweep_work``), the copied rows read and written
    once."""
    from bricklib_tpu_torch.bench.roofline import bound, sweep_work
    from bricklib_tpu_torch.codegen.fused_exchange import (brick_rows,
                                                           pencil_sweep_fusedx)
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import put_plan
    from bricklib_tpu_torch.comm.mesh import make_domain_mesh
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=(N,) * 3, ghost_depth=(8, 8, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    mesh = make_domain_mesh(MESH, devices=["cpu"] * 4)
    fn = pencil_sweep_fusedx("s7pt", dec.periodic_grid((2,)), BD,
                             dec.nbricks, put_plan(dec, MESH, (2,)), MESH,
                             bench_params(), mesh=mesh)
    plan4 = dataclasses.replace(fn.plan, batch=4, batch_stride=dec.nbricks)
    nbytes, flops = sweep_work(plan4)
    moved = sum(r[-1] for r in brick_rows(mesh, fn.copies, dec.nbricks))
    ms, by = bound(nbytes + 2 * moved * 4 * BD[0] * BD[1] * BD[2], flops)
    return {"K11 weak mesh plan 4x512^3 s7pt": {"bound_ms": ms,
                                                 "bound_by": by}}


def step_ms(exchange: str, iters: int) -> float:
    """The weak mesh step at fuse=1, ms per step."""
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms
    from bricklib_tpu_torch.drivers import weak

    step, state, _dec = weak.build_step(
        dims=(N,) * 3, bdim=BD, stencil="s7pt", st_iter=8, fuse=1,
        table_periodic=False, mesh_shape=MESH, exchange=exchange,
        devices=["cuda:0"] * 4)
    box = [state]

    def one():
        box[0] = step(box[0])

    return cuda_ms(one, iters)


def worker(iters: int) -> dict:
    """Every regime's ms per launch and digest, the composition and its
    parts, and the two weak mesh steps, in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    _build.library()
    out = {}
    fn, put, k1, state, dec = case(N, "s7pt")
    name = "K11 weak mesh plan 4x512^3 s7pt"
    flat = state[0].view((-1,) + BD)
    out[name] = cuda_ms(lambda: fn(state), iters)
    out[name + " sha256"] = digest(fn, state)
    out["PUT + K1 (the composition)"] = cuda_ms(
        lambda: (put(state), k1(flat)), iters)
    out["PUT exchange alone"] = cuda_ms(lambda: put(state), iters)
    out["K1 ghost-inclusive x4 alone"] = cuda_ms(lambda: k1(flat), iters)
    del fn, put, k1, state, flat
    torch.cuda.empty_cache()
    for n, stencil, rings in ((SMALL, "mpi125pt", 1), (SMALL, "s27pt", 1),
                              (SMALL, "s7pt", 2)):
        fn, _put, _k1, state, _dec = case(n, stencil, rings)
        name = f"K11 4x{n}^3 {stencil} rings {rings}"
        out[name] = cuda_ms(lambda: fn(state), iters)
        out[name + " sha256"] = digest(fn, state)
        del fn, state
        torch.cuda.empty_cache()
    for ex in ("fused", "put"):
        out[f"weak mesh step fuse=1 {ex}"] = step_ms(ex, 25)
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.iters)))
        return
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import alternate, card

    if not torch.cuda.is_available():
        sys.exit("k11_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K11 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K11", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K11 {name}] {v if isinstance(v, str) else f'{v:.3f} ms'}",
                  flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
