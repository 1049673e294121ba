"""Kernel K2 in every regime its main paths run, timed on the card.

    python -m bricklib_tpu_torch.bench.k2_regimes [--parent DIR] [--pairs N]

K2 moves the local stages of the SHIFT exchange in place.  Each regime is
one exchange (``shift_exchange``) as a path runs it: the weak 512^3 step
(bricks (8, 8, 512), i through the table: 2 stages, 260 brick rows of 128
KiB), the weak 4-D step (16x64x128x512, bricks (4, 8, 8, 512), i through
the table: 3 stages) and the 5-D ``Problem`` on the oracle ((16, 16, 16,
16, 256) per rank, whole-brick ghosts (8, 8, 8, 8, 128), mesh (1, 1, 1, 1,
2), both ranks on one card: one stage across ranks, then 4 local ones).
Per regime, after one warm-up exchange:

- ``ms``: CUDA events around 50 exchanges, per exchange (what
  ``chip_smoke.py``'s ``k2_pairs`` times: the device's time, or the host's
  where the host is slower);
- ``device_ms``: the kernels' own time per exchange, from
  ``torch.profiler`` over 20 exchanges (every CUDA kernel and copy the
  exchange runs);
- ``graph_ms``: 20 exchanges captured in one CUDA graph, replayed, CUDA
  events per exchange (no host work between launches; None where the
  capture fails);
- ``host_ms``: host clock around 50 exchanges enqueued without waiting,
  per exchange (the Python and launch cost);
- ``library_ms`` (one-rank regimes): one indexed assignment per stage of
  the same rows, CUDA events around 50;
- ``launches``: K2 launches per exchange;
- a sha256 of the storage after one exchange from storage made from a
  seed.

With ``--parent DIR`` (an unpacked checkout of another commit), the same
runs in one process per tree, alternating ``parent, change, change,
parent`` ``--pairs`` times, all on one card; the median and spread of each
number per tree are printed, and whether every run of both trees gave the
same digest.  Each regime's bound is printed first: every moved row read
and written once.  The last line is one JSON object of the results, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

WEAK3 = ((512, 512, 512), (8, 8, 512), (8, 8, 0), (1, 1, 1), (2,))
WEAK4 = ((16, 64, 128, 512), (4, 8, 8, 512), (4, 8, 8, 0), (1, 1, 1, 1),
         (3,))
P5 = ((16, 16, 16, 16, 256), (8, 8, 8, 8, 128), (8, 8, 8, 8, 128),
      (1, 1, 1, 1, 2), ())
REGIMES = {"weak 512^3": WEAK3, "weak 4-D": WEAK4,
           "5-D Problem, 2 ranks on one card": P5}


def case(cfg):
    """``(exchange fn, state, dec, one-rank storage or None)`` for one
    regime, on cuda:0, storage made from a seed."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import shift_exchange
    from bricklib_tpu_torch.comm.mesh import make_domain_mesh

    dims, bd, gz, mesh_shape, table_axes = cfg
    dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd).initialize(
        skinlist_by_name("good", len(dims)))
    n = int(np.prod(mesh_shape))
    g = torch.Generator("cuda").manual_seed(7)
    if n == 1:
        x = torch.rand((dec.nbricks,) + bd, device="cuda", generator=g)
        return shift_exchange(dec, mesh_shape, table_axes), x, dec, x
    mesh = make_domain_mesh(mesh_shape, devices=["cuda:0"] * n)
    state = [torch.rand((n, dec.nbricks) + bd, device="cuda", generator=g)]
    return shift_exchange(dec, mesh, table_axes), state, dec, None


def moved_bytes(ex, dec, cfg) -> int:
    """Bytes one exchange must move: every row of every stage, on every
    rank, read and written once."""
    import numpy as np

    ranks = int(np.prod(cfg[3]))
    rows = sum(d1 - d0 for st in ex.stages for d0, d1, _s0, _s1 in st)
    return 2 * 4 * int(np.prod(cfg[1])) * rows * ranks


def bounds() -> dict:
    from bricklib_tpu_torch.bench.roofline import bound
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import shift_stages

    out = {}
    for name, cfg in REGIMES.items():
        dims, bd, gz, mesh_shape, table_axes = cfg
        dec = BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd).initialize(
            skinlist_by_name("good", len(dims)))

        class Ex:
            stages = shift_stages(dec, mesh_shape, table_axes)

        ms, by = bound(moved_bytes(Ex, dec, cfg), 0)
        out[name] = {"bound_ms": ms, "bound_by": by,
                     "stages": len(Ex.stages),
                     "local": sum(not st.remote for st in Ex.stages)}
    return out


def profiled_ms(run, n: int) -> float:
    """The device time of ``run()`` per call over ``n`` calls: every CUDA
    kernel and memory copy ``torch.profiler`` records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3 / n


def graph_ms(run, n: int):
    """``n`` calls of ``run()`` captured in one CUDA graph, replayed: ms
    per call (None where the capture fails)."""
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    try:
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            with torch.cuda.graph(g, stream=s):
                for _ in range(n):
                    run()
        torch.cuda.current_stream().wait_stream(s)
    except Exception as e:  # noqa: BLE001 - a measurement, reported as None
        print(f"graph capture failed: {e!r}", file=sys.stderr)
        return None
    return cuda_ms(g.replay, 5) / n


def worker(iters: int) -> dict:
    """Every regime's numbers and digest in this process's tree."""
    import torch

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms
    from bricklib_tpu_torch.comm.exchange import copy_intervals

    _build.library()
    out = {}
    for name, cfg in REGIMES.items():
        ex, state, dec, x = case(cfg)
        ex(state)
        torch.cuda.synchronize()
        out[name + " sha256"] = hashlib.sha256(
            (state if x is not None else state[0]).cpu().numpy().tobytes()
        ).hexdigest()
        before = copy_intervals.launches
        ex(state)
        out[name + " launches"] = float(copy_intervals.launches - before)
        out[name + " ms"] = cuda_ms(lambda: ex(state), iters)
        out[name + " device_ms"] = profiled_ms(lambda: ex(state), 20)
        gm = graph_ms(lambda: ex(state), 20)
        if gm is not None:
            out[name + " graph_ms"] = gm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            ex(state)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name + " host_ms"] = (t1 - t0) * 1e3 / iters
        if x is not None:
            idx = [(torch.tensor([r for d0, d1, _, _ in st
                                  for r in range(d0, d1)]).cuda(),
                    torch.tensor([r for _, _, s0, s1 in st
                                  for r in range(s0, s1)]).cuda())
                   for st in ex.stages]

            def lib():
                for d, s in idx:
                    x[d] = x[s]

            out[name + " library_ms"] = cuda_ms(lib, iters)
        del ex, state, x
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.iters)))
        return
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import alternate, card

    if not torch.cuda.is_available():
        sys.exit("k2_regimes: needs a CUDA card")
    res = {"card": card(), "bounds": bounds()}
    print(res["card"], flush=True)
    for name, b in res["bounds"].items():
        print(f"[K2 {name}] {b['stages']} stages ({b['local']} local), "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    if a.parent is not None:
        res["pairs"] = alternate(a.parent, a.pairs, a.iters, "K2", __file__)
    else:
        res["this tree"] = worker(a.iters)
        for name, v in res["this tree"].items():
            print(f"[K2 {name}] {v if isinstance(v, str) else f'{v:.4f}'}",
                  flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
