"""Kernel K1 in every regime its main paths run, timed on the card.

    python -m bricklib_tpu_torch.bench.k1_regimes [--parent DIR] [--pairs N]
                                                  [--footprints] [--match S]

Each regime is one pencil sweep at a path's shape (512^3 s7pt, bricks (8,
8, 512), at fuse 4, 2 and 1; the strong stack of 16 subdomains of
128x128x512 at fuse 4 and 2; bench.py's 125-point leg), timed with CUDA
events over ``--iters`` launches after one warm-up; each sweep's output on
the bricks it writes is also digested (sha256), so that two trees that
agree bit for bit say so.  The star at fuse 2 to 4 runs K1's
register-streaming body, every other regime its ring body.  With
``--parent DIR`` (an unpacked checkout of another
commit), the same timing runs in one process per tree, alternating
``parent, change, change, parent`` ``--pairs`` times, all on one card, and
the median and spread (max - min) of each regime per tree are printed; the
processes import the package of their own tree, so the two versions never
share a process.  ``--footprints`` times, in this tree only, the planner's
launch beside neighbouring footprints (k chunk, pencils, i tile; the
planner's lookahead and skewed levels) of the same sweep, and for the
regimes of the register-streaming body its planner's launch beside
neighbouring footprints of that body (k chunk, pencils, i tile and row
width).  The last line is one JSON object of the results, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N, BD = 512, (8, 8, 512)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def regimes(match: str = ""):
    """``[(name, fn, storage shape)]``: every K1 sweep of the main paths
    whose name holds ``match``, with the storage it runs on (made at
    timing time)."""
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.comm import (BrickDecomp, StrongDecomp,
                                         skinlist_by_name)
    from bricklib_tpu_torch.stencils import bench_params

    p = bench_params()
    dec = BrickDecomp(dims=(N,) * 3, ghost_depth=(8, 8, 0),
                      bdims=BD).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    per = dec.periodic_grid((0, 1, 2))
    shape = (dec.nbricks,) + BD
    out = []
    for f in (4, 2):
        out += [(f"weak ghost-inclusive s7pt fuse={f}",
                 pencil_sweep("s7pt", dec.grid, BD, dec.nbricks, p,
                              k_range=(0, GK), j_range=(0, GJ), fuse=f),
                 shape),
                (f"weak owned-only s7pt fuse={f}",
                 pencil_sweep("s7pt", dec.grid, BD, dec.nbricks, p, fuse=f),
                 shape),
                (f"periodic s7pt fuse={f}",
                 pencil_sweep("s7pt", per, BD, dec.nbricks, p, fuse=f),
                 shape)]
    out += [("periodic s7pt fuse=1",
             pencil_sweep("s7pt", per, BD, dec.nbricks, p, fuse=1), shape)]
    sp = StrongDecomp(dom=(N,) * 3, sdom=(N // 4, N // 4, N),
                      mesh_shape=(1, 1, 1), bdims=BD,
                      ghost_depth=(8, 8, 0)).initialize(
        skinlist_by_name("good", 3))
    kg = sp.sdec.periodic_grid((2,))
    nb, nsub = sp.sdec.nbricks, sp.nsub_local
    GK, GJ = kg.shape[:2]
    for f in (4, 2):
        kw = dict(batch=nsub, batch_stride=nb, fuse=f)
        out += [(f"strong x{nsub} ghost-inclusive s7pt fuse={f}",
                 pencil_sweep("s7pt", kg, BD, nsub * nb, p, k_range=(0, GK),
                              j_range=(0, GJ), **kw), (nsub * nb,) + BD),
                (f"strong x{nsub} owned-only s7pt fuse={f}",
                 pencil_sweep("s7pt", kg, BD, nsub * nb, p, **kw),
                 (nsub * nb,) + BD)]
    out += [(f"periodic mpi125pt fuse={f}",
             pencil_sweep("mpi125pt", per, BD, dec.nbricks, p, fuse=f),
             shape) for f in (1, 2)]
    return [r for r in out if match in r[0]]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def storage(shape, seed: int):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    return torch.rand(shape, device="cuda", generator=g)


def digest(fn, x) -> str:
    """sha256 of ``fn(x)`` on the bricks it writes."""
    import torch

    w = torch.from_numpy(fn.plan.written_bricks()).to(x.device)
    return hashlib.sha256(fn(x)[w].cpu().numpy().tobytes()).hexdigest()


def worker(iters: int, match: str = "") -> dict:
    """Every regime's (``match``: holding it in its name) ms per launch
    and its output's digest in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build

    _build.library()
    times, x = {}, None
    for name, fn, shape in regimes(match):
        if x is None or tuple(x.shape) != shape:
            x = None
            torch.cuda.empty_cache()
            x = storage(shape, 3)
        times[name] = cuda_ms(lambda: fn(x), iters)
        times[name + " sha256"] = digest(fn, x)
    return times


def footprints(iters: int, match: str = "") -> dict:
    """Per regime: the planner's launch and its neighbours, ms each; the
    neighbours of the body the regime runs (the register-streaming body's
    for the star at fuse 2 to 4, else the ring body's)."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import (
        REGSTREAM_ITEMS, REGSTREAM_THREADS, STREAM_SMEM_BUDGET,
        _launch_stream, _stream_footprint, launch_regstream, regstream_smem)

    out, x = {}, None
    for name, fn, shape in regimes(match):
        if x is None or tuple(x.shape) != shape:
            x = None
            torch.cuda.empty_cache()
            x = storage(shape, 3)
        plan = fn.plan
        table = torch.from_numpy(plan.table).cuda()
        rp = plan.regstream()
        res = []
        if rp is not None:
            BJ, BI = plan.bdims[1:]
            cands = {(rp.kch, rp.pj, rp.ti, rp.rw, rp.d)}
            for kch in {max(1, rp.kch // 2), rp.kch, 2 * rp.kch, 8, 16, 64}:
                for pj in range(2, 7):
                    for ti, rw in ((32, 40), (64, 72)):
                        for d in (1, 2):
                            cands.add((kch, pj, ti, rw, d))
            for kch, pj, ti, rw, d in sorted(cands):
                nq = -(-(pj * BJ + 2 * plan.fuse) // 4)
                smem = regstream_smem(plan.bdims, plan.fuse, kch, pj, rw,
                                      nq, d)
                if (BI % ti or nq * rw > REGSTREAM_THREADS * REGSTREAM_ITEMS
                        or smem > STREAM_SMEM_BUDGET):
                    continue
                v = dataclasses.replace(rp, kch=kch, pj=pj, ti=ti, rw=rw,
                                        nq=nq, d=d, smem_bytes=smem)
                ms = cuda_ms(lambda: launch_regstream(x, table, plan, v),
                             iters)
                res.append({"body": "regstream", "kch": kch, "pj": pj,
                            "ti": ti, "rw": rw, "d": d, "smem": smem,
                            "blocks": v.nstream, "ms": ms,
                            "planner": v == rp})
        else:
            sp = plan.stream()
            cands = {(sp.kch, sp.pj, sp.ti, sp.d)}
            for kch in {max(1, sp.kch // 2), sp.kch, 2 * sp.kch, 4, 8}:
                for pj in {max(1, sp.pj // 2), sp.pj, 2, 4}:
                    for ti in {sp.ti, 64, 128, 256}:
                        cands.add((kch, pj, ti, sp.d))
            for kch, pj, ti, d in sorted(cands):
                if plan.bdims[2] % ti:
                    continue
                v = _stream_footprint(plan, kch, pj, ti, d, sp.skew)
                if v.smem_bytes > STREAM_SMEM_BUDGET:
                    continue
                ms = cuda_ms(lambda: _launch_stream(x, table, plan, v),
                             iters)
                res.append({"body": "stream", "kch": kch, "pj": pj,
                            "ti": ti, "d": d, "smem": v.smem_bytes,
                            "blocks": v.nstream, "ms": ms,
                            "planner": (kch, pj, ti, d) == (sp.kch, sp.pj,
                                                            sp.ti, sp.d)})
        res.sort(key=lambda r: r["ms"])
        out[name] = res
        for r in res[:4] + [r for r in res if r["planner"]]:
            print(f"[footprint {name}] {r}", flush=True)
    return out


def run_tree(tree: Path, iters: int, script: str = __file__,
             match: str = "") -> dict:
    """``script --worker`` in one process importing ``tree``'s package;
    the JSON object its last line prints."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(
        [sys.executable, str(Path(script).resolve()), "--worker",
         "--iters", str(iters)] + (["--match", match] if match else []),
        cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"worker in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def alternate(parent: Path, pairs: int, iters: int, kernel: str,
              script: str = __file__, match: str = "") -> dict:
    """``script``'s worker in this tree and in ``parent``, alternating
    ``parent, change, change, parent`` ``pairs`` times; per entry of the
    workers' results, each tree's median, spread (max - min) and runs, and
    for an entry that is not a number (a digest of an output) whether
    every run of both trees gave the same one, and this tree's first."""
    runs = {"parent": [], "change": []}
    for _ in range(pairs):
        for who in ("parent", "change", "change", "parent"):
            t = run_tree(parent.resolve() if who == "parent" else ROOT,
                         iters, script, match)
            runs[who].append(t)
            print(f"[{who}] " + ", ".join(
                f"{k} {v:.3f}" for k, v in t.items()
                if isinstance(v, float)), flush=True)
    out = {}
    for name, v0 in runs["change"][0].items():
        if not isinstance(v0, float):
            same = len({t[name] for ts in runs.values() for t in ts}) == 1
            out[name] = {"same": same, "value": v0}
            print(f"[{kernel} {name}] {'equal' if same else 'DIFFERENT'} "
                  f"in every run of both trees ({v0})", flush=True)
            continue
        row = {}
        for who, ts in runs.items():
            v = [t[name] for t in ts]
            row[who] = {"median": statistics.median(v),
                        "spread": max(v) - min(v), "runs": v}
        out[name] = row
        print(f"[{kernel} {name}] parent {row['parent']['median']:.3f} ms "
              f"(spread {row['parent']['spread']:.3f}), change "
              f"{row['change']['median']:.3f} ms (spread "
              f"{row['change']['spread']:.3f}), ratio "
              f"{row['change']['median'] / row['parent']['median']:.3f}",
              flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--footprints", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--match", default="",
                    help="only the regimes whose name holds this")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.iters, a.match)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_regimes: needs a CUDA card")
    res = {"card": card()}
    print(res["card"], flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K1",
                                 match=a.match)
    if a.footprints:
        res["footprints"] = footprints(a.iters, a.match)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
