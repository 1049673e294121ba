"""Kernel K12 in every regime its path runs, timed on the card.

    python -m bricklib_tpu_torch.bench.k12_regimes [--parent DIR] [--pairs N]
                                                   [--footprints]

Each regime is one rank-5+ sweep (``pencil_sweep_nd``) on a pencil
decomposition with one ghost brick on every outer axis and none in i: the
5-D 11-point star at the path's shape ((8, 8, 64, 64, 512), bricks (2, 2,
8, 8, 512), table (6, 6, 10, 10), 3,601 bricks of 512 KiB) over the owned
bricks and over every brick of the table (every table axis clamps at both
edges); a two-input 5-D stencil with corner taps at (4, 4, 16, 16, 256)
and the 6-D star at (4, 4, 4, 8, 8, 128) (the generic body).  Each is
timed with CUDA events over ``--iters`` launches after one warm-up, and
its output on the bricks it writes is digested (sha256), from storage made
from one seed.

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of each
regime per tree are printed, and whether every run of both trees gave the
same digest.  ``--footprints`` times, in this tree only, the planner's
launch beside neighbouring footprints (k chunk, pencils, i tile) of each
regime.  Each regime's bound is printed first: per input, the cells its
taps reach from the computed region (whole i rows) read once, the region
written once, or 2 f32 operations per tap and output.  The last line is
one JSON object of the results, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

DIMS5, BD5 = (8, 8, 64, 64, 512), (2, 2, 8, 8, 512)
DIMS5_2IN, BD5_2IN = (4, 4, 16, 16, 256), (2, 2, 8, 8, 256)
DIMS6, BD6 = (4, 4, 4, 8, 8, 128), (2, 2, 2, 4, 4, 128)


def star_nd(nd: int, two: bool = False, corner: bool = False):
    """The ``2 nd + 1``-point star of the port's tests
    (``tests/torch_nd_stencils.py``, ``chip_smoke.py``): radius 1 on every
    axis, distinct coefficients; ``two`` adds taps of a second input,
    ``corner`` two taps that cross three axes at once."""
    from bricklib_tpu_torch import st

    idx = [st.Index(a) for a in range(nd)]
    g, o = st.Grid("in", nd), st.Grid("out", nd)

    def at(grid, moves):
        ii = list(idx)
        for a, d in moves.items():
            ii[a] = idx[a] + d
        return grid(*ii)

    e = 0.3 * g(*idx)
    for a in range(nd):
        for d in (1, -1):
            e = e + (0.05 + 0.01 * a + 0.003 * d) * at(g, {a: d})
    if corner:
        e = e + 0.07 * at(g, {0: 1, 3: 1, 4: -1}) \
            - 0.02 * at(g, {1: -1, 2: 1, 4: 1})
    if two:
        h = st.Grid("aux", nd)
        e = e + 0.11 * at(h, {2: 1}) - 0.05 * at(h, {4: -1, 0: 1})
    o(*idx).assign(e)
    return st.load_stencil_module({"STENCIL": [o]})[0]


def regimes():
    """``[(name, fn, storage shape, inputs)]``: every K12 sweep timed."""
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import pencil_sweep_nd
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    def case(dims, bd, sdef, ranges=None):
        nd = len(dims)
        dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                          bdims=bd).initialize(skinlist_by_name("good", nd))
        if ranges == "all":
            ranges = tuple((0, g) for g in dec.grid.shape[:-1])
        fn = pencil_sweep_nd(sdef, dec.grid, bd, dec.nbricks, {},
                             ranges=ranges)
        return fn, (dec.nbricks,) + bd, len(getattr(fn, "fields", "x"))

    return [("5-D star (8, 8, 64, 64, 512)", *case(DIMS5, BD5, star_nd(5))),
            ("5-D star, every brick of the table",
             *case(DIMS5, BD5, star_nd(5), "all")),
            ("5-D two-input corners (4, 4, 16, 16, 256)",
             *case(DIMS5_2IN, BD5_2IN, star_nd(5, two=True, corner=True))),
            ("6-D star (4, 4, 4, 8, 8, 128)",
             *case(DIMS6, BD6, star_nd(6)))]


def reach(region, offsets) -> int:
    """Cells of the union of a box of extents ``region`` shifted by each
    of ``offsets``."""
    import numpy as np

    offs = np.asarray(offsets, np.int64).reshape(len(offsets), -1)
    lo, hi = np.maximum(-offs.min(0), 0), np.maximum(offs.max(0), 0)
    mask = np.zeros([n + a + b for n, a, b in zip(region, lo, hi)], bool)
    for o in offs:
        mask[tuple(slice(a + d, a + d + n)
                   for a, d, n in zip(lo, o, region))] = True
    return int(mask.sum())


def work(plan, nf: int) -> tuple[int, int]:
    """(bytes, f32 operations) one K12 sweep must move and do: per input,
    the cells its taps reach from the computed region (whole i rows) read
    once; the region written once; a multiply and an add per tap and
    output."""
    import numpy as np

    counts = [b - a for a, b in plan.ranges]
    region = [c * b for c, b in zip(counts, plan.bdims)] + [plan.bdims[-1]]
    offs = plan.taps.offsets
    field = (plan.taps.inputs if plan.taps.inputs is not None
             else np.zeros(len(offs), np.int64))
    nread = region[-1] * sum(reach(region[:-1], offs[field == f, :-1])
                             for f in range(nf))
    nout = int(np.prod(region))
    return 4 * (nread + nout), 2 * len(plan.taps.coeffs) * nout


def bounds() -> dict:
    from bricklib_tpu_torch.bench.roofline import bound

    out = {}
    for name, fn, _shape, nf in regimes():
        ms, by = bound(*work(fn.plan, nf))
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out


def digest(out, plan) -> str:
    """sha256 of ``out`` on the bricks ``plan`` writes."""
    import torch

    w = torch.from_numpy(plan.written_bricks()).to(out.device)
    return hashlib.sha256(out[w].cpu().numpy().tobytes()).hexdigest()


def worker(iters: int) -> dict:
    """Every regime's ms per launch and digest in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage

    _build.library()
    out = {}
    for name, fn, shape, nf in regimes():
        xs = [storage(shape, 3 + f) for f in range(nf)]
        out[name] = cuda_ms(lambda: fn(*xs), iters)
        out[name + " sha256"] = digest(fn(*xs), fn.plan)
        del xs
        torch.cuda.empty_cache()
    return out


def footprints(iters: int) -> dict:
    """Per regime: the planner's launch and its neighbours, ms each."""
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import (
        K12_SMEM_BUDGET, nd_info, pencil_sweep_nd_kernel, stream_nd_footprint,
        stream_plan_nd)

    out = {}
    for name, fn, shape, nf in regimes():
        plan = fn.plan
        xs = [storage(shape, 3 + f) for f in range(nf)]
        table = torch.from_numpy(plan.table).cuda()
        sp = stream_plan_nd(plan)
        cands = {(sp.kch, sp.pj, sp.ti, sp.d)}
        for kch in {sp.kch, max(1, sp.kch // 2), 2 * sp.kch, 1, 4}:
            for pj in {sp.pj, 1, 2}:
                for ti in {sp.ti, 32, 64, 128, 256}:
                    for d in (1, 2):
                        cands.add((kch, pj, ti, d))
        res = []
        for kch, pj, ti, d in sorted(cands):
            if plan.bdims[-1] % ti or kch > plan.ranges[-2][1]:
                continue
            v = stream_nd_footprint(plan, kch, pj, ti, d)
            if v.smem_bytes > K12_SMEM_BUDGET:
                continue
            info = torch.from_numpy(nd_info(plan, v)[0]).cuda()
            ms = cuda_ms(lambda: pencil_sweep_nd_kernel(xs, table, info,
                                                        plan, v), iters)
            res.append({"kch": kch, "pj": pj, "ti": ti, "d": d,
                        "smem": v.smem_bytes, "blocks": v.nstream, "ms": ms,
                        "planner": (kch, pj, ti, d) == (sp.kch, sp.pj,
                                                        sp.ti, sp.d)})
        res.sort(key=lambda r: r["ms"])
        out[name] = res
        for r in res[:4] + [r for r in res if r["planner"]]:
            print(f"[footprint {name}] {r}", flush=True)
        del xs
        torch.cuda.empty_cache()
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
        sys.exit("k12_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K12 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K12", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K12 {name}] {v if isinstance(v, str) else f'{v:.3f} ms'}",
                  flush=True)
    if a.footprints:
        res["footprints"] = footprints(a.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
