"""Kernel K7 in every regime its path runs, timed on the card.

    python -m bricklib_tpu_torch.bench.k7_regimes [--parent DIR] [--pairs N]
                                                  [--footprints]

K7 is the dense padded-array stencil of the out-of-core pass
(``ooc.ooc_sweep``, one launch per k-slab).  Each regime is one K7 call at
a slab of that pass at 1024^3 with the reference's 2 GiB slab budget:
s7pt on the first slab (149 x 1040 x 1152 padded, pads (1, 8, 64)) and on
the last, shorter one (144 rows) through the compiled star; mpi13pt
(radius 2: pads (2, 8, 64)) and s27pt on the first slab through the
generic body.  Each is timed with CUDA events over ``--iters`` launches
after one warm-up and digested (sha256 of the whole padded output), from
input made from one seed.  Then one whole out-of-core pass (s7pt, a
host-resident 1024^3 array made from a seed, 7 slabs): its wall seconds on
the host clock, with the pass's own split (host padding, host blocked on
the card, host copy-out), and the digest of the array it returns.

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of each
number per tree are printed, and whether every run of both trees gave the
same digest.  ``--footprints`` times, in this tree only, the planner's
launch on the first slab beside neighbouring footprints (k chunk, j rows,
i lanes, planes ahead).  Each regime's bound is printed first: the input
rows the taps reach from the interior (whole padded i rows) read once per
field, the padded output written once, or 2 f32 operations per tap and
output.  The last line is one JSON object of the results, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

SLAB, LAST = (149, 1040, 1152), (144, 1040, 1152)
N_OOC, SLAB_BYTES = 1024, 2 * 2 ** 30
REGIMES = {"s7pt first slab": ("s7pt", SLAB, (1, 8, 64)),
           "s7pt last slab": ("s7pt", LAST, (1, 8, 64)),
           "mpi13pt first slab (generic)": ("mpi13pt", (151, 1040, 1152),
                                            (2, 8, 64)),
           "s27pt first slab (generic)": ("s27pt", SLAB, (1, 8, 64))}


def stencil(name, shape, pad):
    from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil
    from bricklib_tpu_torch.stencils import bench_params

    return dense_stencil(name, shape, pad, bench_params())


def work(plan) -> tuple[int, int]:
    """(bytes, f32 operations) one K7 call must move and do."""
    (SK, SJ, SI), (pk, pj, _pi) = plan.shape, plan.pad
    rows = SK - 2 * pk
    (klo, jlo, _), (khi, jhi, _) = plan.lo, plan.hi
    nread = (rows + klo + khi) * (SJ - 2 * pj + jlo + jhi) * SI
    nf = len(plan.fields)
    return (4 * (nf * nread + SK * SJ * SI),
            2 * len(plan.taps) * rows * (SJ - 2 * pj) * SI)


def bounds() -> dict:
    from bricklib_tpu_torch.bench.roofline import bound

    out = {}
    for name, (st, shape, pad) in REGIMES.items():
        ms, by = bound(*work(stencil(st, shape, pad).plan))
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out


def ooc_pass() -> dict:
    """One out-of-core pass of s7pt over a 1024^3 host array."""
    import numpy as np

    from bricklib_tpu_torch.ooc import ooc_sweep
    from bricklib_tpu_torch.stencils import bench_params

    host = np.random.default_rng(35).random((N_OOC,) * 3, np.float32)
    stats = {}
    ooc_sweep(host, "s7pt", bench_params(), slab_bytes=SLAB_BYTES)  # warm
    t0 = time.perf_counter()
    got = ooc_sweep(host, "s7pt", bench_params(), slab_bytes=SLAB_BYTES,
                    stats=stats)
    wall = time.perf_counter() - t0
    return {"ooc pass s": wall, "ooc pass wall_s": stats["wall_s"],
            "ooc pass pad_s": stats["pad_s"],
            "ooc pass wait_s": stats["wait_s"],
            "ooc pass copy_out_s": stats["copy_out_s"],
            "ooc pass sha256": hashlib.sha256(got.tobytes()).hexdigest()}


def worker(iters: int) -> dict:
    """Every regime's ms per launch and digest in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage

    _build.library()
    out = {}
    for name, (st, shape, pad) in REGIMES.items():
        fn = stencil(st, shape, pad)
        x = storage(shape, 3)
        out[name] = cuda_ms(lambda: fn(x), iters)
        out[name + " sha256"] = hashlib.sha256(
            fn(x).cpu().numpy().tobytes()).hexdigest()
        del x
        torch.cuda.empty_cache()
    out.update(ooc_pass())
    return out


def footprints(iters: int) -> dict:
    """The planner's launch on the first slab and its neighbours, ms
    each."""
    import dataclasses

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms, storage
    from bricklib_tpu_torch.codegen.dense_kernel import (dense_smem,
                                                         launch_dense)
    from bricklib_tpu_torch.codegen.pencil_kernel import STREAM_SMEM_BUDGET

    fn = stencil(*REGIMES["s7pt first slab"])
    plan, sp = fn.plan, fn.plan.stream()
    x = storage(plan.shape, 3)
    nk = plan.shape[0] - 2 * plan.pad[0]
    cands = {(sp.kch, sp.tj, sp.ti, sp.d)}
    for kch in {sp.kch, -(-nk // 2), -(-nk // 4), -(-nk // 7), 21, 8}:
        for tj in {sp.tj, 8, 16, 32, 64}:
            for ti in {sp.ti, 64, 128, 192, 384}:
                cands.add((kch, tj, ti, sp.d))
    cands |= {(sp.kch, sp.tj, sp.ti, 1)}
    res = []
    for kch, tj, ti, d in sorted(cands):
        if plan.shape[2] % ti or dense_smem(1, plan.lo, plan.hi, tj, ti,
                                            sp.h, d) > STREAM_SMEM_BUDGET:
            continue
        v = dataclasses.replace(sp, kch=kch, tj=tj, ti=ti, d=d)
        ms = cuda_ms(lambda: launch_dense([x], plan, v), iters)
        res.append({"kch": kch, "tj": tj, "ti": ti, "d": d,
                    "blocks": v.nblocks, "ms": ms,
                    "planner": (kch, tj, ti, d) == (sp.kch, sp.tj, sp.ti,
                                                    sp.d)})
    res.sort(key=lambda r: r["ms"])
    for r in res[:6] + [r for r in res if r["planner"]]:
        print(f"[footprint s7pt first slab] {r}", flush=True)
    return {"s7pt first slab": res}


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
        sys.exit("k7_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K7 {name}] bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K7", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K7 {name}] {v if isinstance(v, str) else f'{v:.4f}'}",
                  flush=True)
    if a.footprints:
        res["footprints"] = footprints(a.iters)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
