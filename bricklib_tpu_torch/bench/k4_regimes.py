"""Kernel K4 in every regime its main paths run, timed on the card.

    python -m bricklib_tpu_torch.bench.k4_regimes [--parent DIR] [--pairs N]
                                                  [--footprints]

Each regime is one 4-D pencil sweep at the weak 4-D step's shape
(16x64x128x512, ``mpi9pt``, bricks (4, 8, 8, 512), ghost (4, 8, 8, 0),
1,081 bricks): ``fuse=1`` and ``fuse=2`` on the periodic table (does
fusing pay per iteration?), ``fuse=1`` to ``fuse=4`` over every brick of
the table (ghost-inclusive), ``fuse=2`` over the owned bricks, and a
4-tap stencil of mixed radii (the generic body) ghost-inclusive at
``fuse=2``; the star at ``fuse=2`` runs K4's register-streaming body
(``regstream_plan_4d``), the others its ring body.  Each is timed with
CUDA events over
``--iters`` launches after one warm-up.  Besides: the weak 4-D step
(``drivers.weak.run``, two ``fuse=2`` sweeps and the SHIFT exchange, 25
timed steps) with its exchange's marginal ms, and the 4-D ``Problem`` at
(8, 16, 16, 64), ``st_iter`` 2 (one ``fuse=2`` sweep a step, 25 steps).
Each sweep's output on the bricks it writes is also digested (sha256),
from storage made from one seed.

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread (max -
min) of each regime per tree are printed, and whether every run of both
trees gave the same digest (the two K4s agree bit for bit).  The processes
import the package of their own tree.  ``--footprints`` times, in this
tree only, the planner's launch beside neighbouring footprints of the
body each sweep runs (ring body: w chunk, k brick rows, pencils, i tile,
the planner's lookahead and skewed levels; register-streaming body: w
chunk, k brick rows, pencils, i tile, lookahead).  Each regime's bound (bytes or f32 operations at the
card's peak rates, counted from its shapes) is printed first.  The last
line is one JSON object of the results, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

DIMS, BD, PROBLEM = (16, 64, 128, 512), (4, 8, 8, 512), (8, 16, 16, 64)


def mixed_radius():
    """Radii w 1, k 2, j 2, i 1 over four taps (the JAX package's
    ``test_pencil_4d_fused_mixed_radii``): not the star."""
    from bricklib_tpu_torch import st

    inp, out = st.Grid("in", 4), st.Grid("out", 4)
    i, j, k, w = st.Index(0), st.Index(1), st.Index(2), st.Index(3)
    out(i, j, k, w).assign(
        st.FloatLiteral(0.3) * inp(i, j, k, w)
        + st.FloatLiteral(0.11) * inp(i + 1, j, k - 2, w)
        + st.FloatLiteral(0.07) * inp(i - 1, j + 2, k, w - 1)
        + st.FloatLiteral(0.05) * inp(i, j - 1, k + 1, w + 1))
    return st.load_stencil_module({"STENCIL": [out]})[0]


def regimes():
    """``(dec, [(name, fn)])``: every K4 sweep of the weak 4-D step, and
    the generic body's, all on the storage of ``dec``."""
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import pencil_sweep_4d
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.stencils import bench_params

    p = bench_params()
    dec = BrickDecomp(dims=DIMS, ghost_depth=BD[:3] + (0,),
                      bdims=BD).initialize(skinlist_by_name("good", 4))
    G = dec.grid.shape[:3]
    ghost = dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2]))
    per = dec.periodic_grid((0, 1, 2, 3))

    def sweep(stencil, grid, fuse, prm=p, **kw):
        return pencil_sweep_4d(stencil, grid, BD, dec.nbricks, prm,
                               fuse=fuse, **kw)

    return dec, [("fuse=1 periodic skip", sweep("mpi9pt", per, 1)),
                 ("fuse=2 periodic skip", sweep("mpi9pt", per, 2)),
                 ("fuse=1 ghost-inclusive",
                  sweep("mpi9pt", dec.grid, 1, **ghost)),
                 ("fuse=2 ghost-inclusive",
                  sweep("mpi9pt", dec.grid, 2, **ghost)),
                 ("fuse=3 ghost-inclusive",
                  sweep("mpi9pt", dec.grid, 3, **ghost)),
                 ("fuse=4 ghost-inclusive",
                  sweep("mpi9pt", dec.grid, 4, **ghost)),
                 ("fuse=2 skip", sweep("mpi9pt", dec.grid, 2)),
                 ("generic taps fuse=2 ghost-inclusive",
                  sweep(mixed_radius(), dec.grid, 2, {}, **ghost))]


def bounds() -> dict:
    """Per regime, the least time the card could take for its work
    (``roofline.bound`` of ``roofline.sweep_work``: bytes over 3.35 TB/s
    or f32 operations over 67 TFLOP/s, the larger), counted from the
    shapes alone."""
    from bricklib_tpu_torch.bench.roofline import bound, sweep_work

    _dec, cases = regimes()
    out = {}
    for name, fn in cases:
        ms, by = bound(*sweep_work(fn.plan))
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out


def digest(fn, x) -> str:
    """sha256 of ``fn(x)`` on the bricks it writes."""
    import torch

    w = torch.from_numpy(fn.plan.written_bricks()).to(x.device)
    return hashlib.sha256(fn(x)[w].cpu().numpy().tobytes()).hexdigest()


def problem_ms(iters: int) -> float:
    """The 4-D ``Problem``'s step, ms (CUDA events after one warm-up)."""
    from bricklib_tpu_torch.api import Problem
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    p = Problem(dims=PROBLEM, stencil="mpi9pt", st_iter=2).init(seed=0)
    return cuda_ms(lambda: p.step(1), iters)


def worker(iters: int) -> dict:
    """Every regime's ms per launch (and its output's digest), the weak
    4-D step's ms and its exchange's, and the 4-D ``Problem``'s step, in
    this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.drivers import weak

    _build.library()
    dec, cases = regimes()
    x = storage((dec.nbricks,) + BD, 3)
    out = {}
    for name, fn in cases:
        out[name] = cuda_ms(lambda: fn(x), iters)
        out[name + " sha256"] = digest(fn, x)
    del x
    torch.cuda.empty_cache()
    r = weak.run(dims=DIMS, bdim=BD, stencil="mpi9pt", st_iter=4, fuse=2,
                 backend="pencil", table_periodic=False, iters=25,
                 validate=False)
    out["weak 4-D step"] = r["step"] * 1e3
    out["weak 4-D exchange (marginal)"] = r["exchange"] * 1e3
    out["Problem 4-D (8, 16, 16, 64) step"] = problem_ms(25)
    return out


def footprints(iters: int) -> dict:
    """Per regime: the planner's launch and its neighbours, ms each, of
    the body the regime runs."""
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        K4_SMEM_BUDGET, REGSTREAM4_THREADS, launch_4d,
        launch_regstream_4d, regstream4_footprint, regstream_plan_4d,
        stream4_footprint, stream_plan_4d)

    dec, cases = regimes()
    x = storage((dec.nbricks,) + BD, 3)
    out = {}
    for name, fn in cases:
        plan = fn.plan
        table = torch.from_numpy(plan.table).cuda()
        rp = regstream_plan_4d(plan)
        res = []
        if rp is not None:
            BI = plan.bdims[3]
            cands = {(rp.wch, rp.pk, rp.pj, rp.ti, rp.rw, rp.d)}
            for wch in {rp.wch, max(1, rp.wch // 2), 1}:
                for pk in (1, 2):
                    for ti in (8, 16, 32):
                        for d in (1, 2, 3):
                            cands.add((wch, pk, rp.pj, ti, rp.rw, d))
            for wch, pk, pj, ti, rw, d in sorted(cands):
                v = regstream4_footprint(plan, wch, pk, pj, ti, rw, d)
                smem = v.smem_bytes
                if (BI % ti or smem > K4_SMEM_BUDGET
                        or v.items() > REGSTREAM4_THREADS):
                    continue
                ms = cuda_ms(lambda: launch_regstream_4d(x, table, plan, v),
                             iters)
                res.append({"body": "regstream", "wch": wch, "pk": pk,
                            "pj": pj, "ti": ti, "rw": rw, "d": d,
                            "smem": smem, "blocks": v.nstream, "ms": ms,
                            "planner": v == rp})
        else:
            sp = stream_plan_4d(plan)
            cands = set()
            for wch in {sp.wch, max(1, sp.wch // 2), 1}:
                for pk in {sp.pk, 1, 2}:
                    for pj in {sp.pj, 1, 2, 3}:
                        for ti in {sp.ti, max(sp.pw, sp.ti // 2),
                                   2 * sp.ti}:
                            for skew in {sp.skew, 0}:
                                cands.add((wch, pk, pj, ti, sp.d, skew))
            for wch, pk, pj, ti, d, skew in sorted(cands):
                if plan.bdims[3] % ti:
                    continue
                v = stream4_footprint(plan, wch, pk, pj, ti, d, skew)
                if v.smem_bytes > K4_SMEM_BUDGET:
                    continue
                ms = cuda_ms(lambda: launch_4d(x, table, plan, v), iters)
                res.append({"body": "stream", "wch": wch, "pk": pk,
                            "pj": pj, "ti": ti, "d": d, "skew": skew,
                            "smem": v.smem_bytes, "blocks": v.nstream,
                            "ms": ms,
                            "planner": (wch, pk, pj, ti, d, skew) == (
                                sp.wch, sp.pk, sp.pj, sp.ti, sp.d,
                                sp.skew)})
        res.sort(key=lambda r: r["ms"])
        out[name] = res
        for r in res[:4] + [r for r in res if r["planner"]]:
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
        sys.exit("k4_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K4 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K4", __file__)
    if a.footprints:
        res["footprints"] = footprints(a.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
