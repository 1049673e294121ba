"""Kernel K6 in every regime its main paths run, timed on the card.

    python -m bricklib_tpu_torch.bench.k6_regimes [--parent DIR] [--pairs N]
                                                  [--footprints]

Each regime is one 2-D sweep at the 2-D path's shape (16384^2, bricks
(32, 16384), bench.py's 9-point box on the periodic row table): the box
at ``fuse=4`` (the 2-D ``Problem``'s sweep), ``fuse=2`` and ``fuse=1``,
and the wave system of ``examples/wave_2d.py`` (two fields in, two out,
``fuse=1``); each is timed with CUDA events over ``--iters`` launches
after one warm-up, and its outputs on the bricks it writes are digested
(sha256), from storage made from one seed.  Besides: the 2-D ``Problem``
step (``st_iter`` 4, one ``fuse=4`` sweep a step) and the same problem on
mesh (2, 1), both ranks on one card (a SHIFT exchange along y, then a
sweep per rank), 10 timed steps after one each.

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of
each regime per tree are printed, and whether every run of both trees gave
the same digest.  ``--footprints`` times, in this tree only, the planner's
launch beside neighbouring footprints (brick rows per chunk, x tile,
lookahead, rows per group).  Each regime's bound is printed first.  The
last line is one JSON object of the results, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

N2, BY2 = 16384, 32


def stencil_2d(name: str):
    """A stencil of ``tests/torch_2d_stencils.py`` (``box9``, ``wave``)
    in the port's eDSL."""
    tests = str(Path.cwd() / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_2d_stencils import BUILDERS

    from bricklib_tpu_torch import st

    return BUILDERS[name](st)


def regimes():
    """``(nbricks, [(name, fn)])``: every K6 sweep, all on the storage of
    one periodic row table."""
    import numpy as np

    from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d
    from bricklib_tpu_torch.core import init_grid

    grid, info = init_grid((N2 // BY2 + 2, 1))
    t = np.asarray(grid)[:, 0].copy()
    t[0], t[-1] = t[-2], t[1]
    nb = info.nbricks
    box9, wave = stencil_2d("box9"), stencil_2d("wave")

    def sweep(sd, fuse):
        return pencil_sweep_2d(sd, t, (BY2, N2), nb, fuse=fuse)

    return nb, [("box9 fuse=4", sweep(box9, 4)),
                ("box9 fuse=2", sweep(box9, 2)),
                ("box9 fuse=1", sweep(box9, 1)),
                ("wave fuse=1", sweep(wave, 1))]


def bounds() -> dict:
    from bricklib_tpu_torch.bench.roofline import bound, sweep_work

    _nb, cases = regimes()
    out = {}
    for name, fn in cases:
        ms, by = bound(*sweep_work(fn.plan))
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out


def digest(fn, xs) -> str:
    """sha256 of ``fn(*xs)`` on the bricks it writes, every output."""
    import torch

    w = torch.from_numpy(fn.plan.written_bricks()).to(xs[0].device)
    got = fn(*xs)
    got = got if isinstance(got, tuple) else (got,)
    h = hashlib.sha256()
    for g in got:
        h.update(g[w].cpu().numpy().tobytes())
    return h.hexdigest()


def problem_ms(iters: int, mesh=None) -> float:
    """The 2-D ``Problem`` step (on ``mesh``, ranks on cuda:0), ms."""
    from bricklib_tpu_torch.api import Problem
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    kw = {} if mesh is None else dict(mesh=mesh, devices=["cuda:0"] * 2)
    p = Problem(dims=(N2, N2), stencil=stencil_2d("box9"), st_iter=4,
                **kw).init(seed=0)
    return cuda_ms(lambda: p.step(1), iters)


def worker(iters: int) -> dict:
    """Every regime's ms per launch and digest, and the ``Problem`` steps,
    in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage

    _build.library()
    nb, cases = regimes()
    xs = [storage((nb, BY2, N2), 3 + f) for f in range(2)]
    out = {}
    for name, fn in cases:
        args = xs[:len(fn.plan.fields)]
        out[name] = cuda_ms(lambda: fn(*args), iters)
        out[name + " sha256"] = digest(fn, args)
    del xs
    torch.cuda.empty_cache()
    out["Problem 16384^2 box9 step"] = problem_ms(10)
    torch.cuda.empty_cache()
    out["Problem 16384^2 box9 mesh (2, 1) step"] = problem_ms(10, (2, 1))
    return out


def footprints(iters: int) -> dict:
    """Per regime: the planner's launch and its neighbours, ms each."""
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        K6_SMEM_BUDGET, launch_2d, row_footprint)

    nb, cases = regimes()
    xs = [storage((nb, BY2, N2), 3 + f) for f in range(2)]
    out = {}
    for name, fn in cases:
        plan = fn.plan
        args = xs[:len(plan.fields)]
        table = torch.from_numpy(plan.table).cuda()
        sp = plan.stream()
        cands = {(sp.ych, sp.tx, sp.d, sp.g)}
        for ych in {sp.ych, max(1, sp.ych // 2), 2 * sp.ych, 4, 8, 16, 32}:
            for tx in {sp.tx, 120, 128, 152, 248, 256, 344, 504}:
                for d in (1, 2, 3):
                    for g in {sp.g, 8, 16}:
                        cands.add((ych, tx, d, g))
        res = []
        for ych, tx, d, g in sorted(cands):
            v = row_footprint(plan, ych, tx, d, g)
            if v.smem_bytes > K6_SMEM_BUDGET or g < plan.lo[0] + plan.hi[0]:
                continue
            ms = cuda_ms(lambda: launch_2d(args, table, plan, v), iters)
            res.append({"ych": ych, "tx": tx, "d": d, "g": g,
                        "smem": v.smem_bytes, "blocks": v.nstream, "ms": ms,
                        "planner": (ych, tx, d, g) == (sp.ych, sp.tx, sp.d,
                                                       sp.g)})
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
        sys.exit("k6_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K6 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K6", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K6 {name}] {v if isinstance(v, str) else f'{v:.3f} ms'}",
                  flush=True)
    if a.footprints:
        res["footprints"] = footprints(a.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
