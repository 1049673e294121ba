"""Kernel K8 in every regime its main path runs, timed on the card.

    python -m bricklib_tpu_torch.bench.k8_regimes [--parent DIR] [--pairs N]
                                                  [--footprints]

Each regime is one flat-pencil sweep at the 125-point leg's shape (512^3,
bricks (8, 8, 512), 4,357 bricks): ``mpi125pt`` on the periodic table
(the leg's sweep, the compiled layout), over every brick of the exchange
table (ghost-inclusive: both table edges clamp), and ``mpi25pt`` and
``s7pt`` on the periodic table (the generic body); each is timed with
CUDA events over ``--iters`` launches after one warm-up, and its output on
the bricks it writes is digested (sha256), from storage made from one
seed.  Besides: K1 at ``fuse=1`` on the same periodic ``mpi125pt`` sweep
in the same process (the pencil backend's form of the same function), and
the 125-point ``Problem`` step with ``backend="mxu"`` (``st_iter`` 8,
eight K8 sweeps a step, 5 timed steps after one).

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of
each regime per tree are printed, and whether every run of both trees gave
the same digest.  ``--footprints`` times, in this tree only, the planner's
launch beside neighbouring footprints (k chunk, pencils, lane chunks,
lookahead) of each sweep.  Each regime's bound is printed first.  The last
line is one JSON object of the results, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

N, BD = 512, (8, 8, 512)


def regimes():
    """``(dec, [(name, fn)])``: every K8 sweep, on the storage of
    ``dec`` viewed as flat pencils."""
    from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.stencils import bench_params

    p = bench_params()
    dec = BrickDecomp(dims=(N,) * 3, ghost_depth=(8, 8, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    per = dec.periodic_grid((0, 1, 2))

    def sweep(stencil, grid, **kw):
        return pencil_sweep_mxu(stencil, grid, BD, dec.nbricks, p, **kw)

    return dec, [
        ("mpi125pt periodic", sweep("mpi125pt", per)),
        ("mpi125pt ghost-inclusive",
         sweep("mpi125pt", dec.grid, k_range=(0, GK), j_range=(0, GJ))),
        ("mpi25pt periodic (generic body)", sweep("mpi25pt", per)),
        ("s7pt periodic (generic body)", sweep("s7pt", per))]


def work(plan) -> tuple[int, int]:
    """(bytes, f32 operations) one K8 sweep must move and do: each brick
    it reads through the table (the output bricks and their neighbours)
    read once, each brick it writes written once, and the factorized
    form's operations per output (``MxuPlan.flops_per_output``)."""
    import numpy as np

    t = plan.table
    win = t[tuple(slice(max(a - 1, 0), min(b + 1, n))
                  for (a, b), n in zip(plan.ranges, t.shape))]
    belems = int(np.prod(plan.bdims))
    nread, nwritten = len(np.unique(win)), len(plan.written_bricks())
    return (4 * belems * (nread + nwritten),
            plan.flops_per_output() * nwritten * belems)


def bounds() -> dict:
    from bricklib_tpu_torch.bench.roofline import bound

    _dec, cases = regimes()
    out = {}
    for name, fn in cases:
        ms, by = bound(*work(fn.plan))
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out


def digest(fn, x) -> str:
    """sha256 of ``fn(x)`` on the bricks it writes."""
    import torch

    w = torch.from_numpy(fn.plan.written_bricks()).to(x.device)
    return hashlib.sha256(fn(x)[w].cpu().numpy().tobytes()).hexdigest()


def problem_ms(iters: int) -> float:
    """The 125-point ``Problem`` step over K8, ms."""
    from bricklib_tpu_torch.api import Problem
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    p = Problem(dims=(N,) * 3, stencil="mpi125pt", st_iter=8,
                backend="mxu").init(seed=0)
    return cuda_ms(lambda: p.step(1), iters)


def worker(iters: int) -> dict:
    """Every regime's ms per launch and digest, K1's at fuse=1 on the
    periodic sweep, and the ``Problem`` step, in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params

    _build.library()
    dec, cases = regimes()
    x = storage((dec.nbricks,) + BD, 3)
    xf = x.view(dec.nbricks, BD[0], -1)
    out = {}
    for name, fn in cases:
        out[name] = cuda_ms(lambda: fn(xf), iters)
        out[name + " sha256"] = digest(fn, xf)
    k1 = pencil_sweep("mpi125pt", cases[0][1].plan.table, BD, dec.nbricks,
                      bench_params())
    out["K1 fuse=1 mpi125pt periodic"] = cuda_ms(lambda: k1(x), iters)
    del x, xf
    torch.cuda.empty_cache()
    out["Problem 512^3 mpi125pt mxu step"] = problem_ms(5)
    return out


def footprints(iters: int) -> dict:
    """Per regime: the planner's launch and its neighbours, ms each."""
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.mxu_kernel import (
        K8_MAX_THREADS, K8_SMEM_BUDGET, K8_STRIP, launch_mxu, mxu_footprint)

    dec, cases = regimes()
    xf = storage((dec.nbricks, BD[0], BD[1] * BD[2]), 3)
    out = {}
    for name, fn in cases:
        plan = fn.plan
        table = torch.from_numpy(plan.table).cuda()
        sp = plan.stream()
        cands = {(sp.kch, sp.pj, sp.nwc, sp.d)}
        for kch in {sp.kch, max(1, sp.kch // 2), 2 * sp.kch, 4, 16}:
            for pj in {sp.pj, 1, 2, 3, 4}:
                for nwc in {sp.nwc, 1, 2, 4, 5, 8}:
                    cands.add((kch, pj, nwc, sp.d))
        res = []
        for kch, pj, nwc, d in sorted(cands):
            nstrip = -(-pj * BD[1] // K8_STRIP)
            v = mxu_footprint(plan, kch, pj, nwc, d)
            if (v.smem_bytes > K8_SMEM_BUDGET or v.ti % v.pw
                    or 32 * nstrip * nwc > K8_MAX_THREADS):
                continue
            ms = cuda_ms(lambda: launch_mxu(xf, table, plan, v), iters)
            res.append({"kch": kch, "pj": pj, "nwc": nwc, "ti": v.ti,
                        "d": d, "smem": v.smem_bytes, "threads": v.threads,
                        "blocks": v.nstream, "ms": ms,
                        "planner": (kch, pj, nwc, d) == (sp.kch, sp.pj,
                                                         sp.nwc, sp.d)})
        res.sort(key=lambda r: r["ms"])
        out[name] = res
        for r in res[:5] + [r for r in res if r["planner"]]:
            print(f"[footprint {name}] {r}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--footprints", action="store_true")
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.iters)))
        return
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import alternate, card

    if not torch.cuda.is_available():
        sys.exit("k8_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K8 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K8", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K8 {name}] {v if isinstance(v, str) else f'{v:.3f} ms'}",
                  flush=True)
    if a.footprints:
        res["footprints"] = footprints(a.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
