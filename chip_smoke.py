#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bricklib_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. records the toolchain (card name and power limit, torch, CUDA, nvcc,
   whether ``triton`` imports);
2. builds the port's CUDA kernels from ``bricklib_tpu_torch/csrc`` with
   nvcc, one process per source;
3. holds each kernel against its plain PyTorch version on the card:
   K1 (fused pencil sweep) at 32^3 and 512^3 in three configurations and
   batched over the 16 subdomains of the strong stack, K4 (fused 4-D
   sweep) at a tiny and the full 4-D shape in four configurations, K6
   (2-D whole-row sweep) at the full 16384^2 storage (9-point box at
   fuse=1 and fuse=4, the wave system) and on a tiny radius-2 stencil
   through the edge clamps, all at abs-or-rel 1e-5 (FMA contraction and
   summation order); K2 (exchange interval copies), K3 (storage copy) and
   K5 (strong exchange stage, on every (stage, sign) of the full strong
   plan) bit-exact;
4. drives the port's paths, each validated against a dense twin at 1e-4
   and timed: the honest 512^3 weak step (SHIFT exchange + two fuse=4
   s7pt sweeps, ``drivers.weak``), the 4-D weak step (16x64x128x512,
   mpi9pt, SHIFT exchange + two fuse=2 sweeps, ``drivers.weak``), the
   one-card strong step (512^3 as 16 subdomains of 128x128x512, s7pt,
   strong exchange + two batched fuse=4 sweeps, ``drivers.strong``), and
   ``api.Problem``: 16384^2 with bench.py's 9-point box (one fuse=4 K6
   sweep per step), the wave system of ``examples/wave_2d.py`` at
   16384^2, and small 3-D and 4-D problems over K1 and K4;
5. checks from the launch counters, set to 0 just before each path and
   read just after, that each path ran through its kernels;
6. times each kernel beside its plain version, the least time the card
   could take for the same work (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, the larger) and, where one PyTorch call computes the
   same function, that call.

Any failure exits non-zero.  Without a CUDA card, or outside a checkout of
the repository, it exits non-zero and prints no result.  The line before
the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_BIG = 512
BD_K, BD_J = 8, 8
ST_ITER, FUSE = 8, 4
K1_TOL = 1e-5
# the 4-D weak step: the JAX package's 4-D benchmark shape
# (tools/bench_4d.py:55-57), ST_ITER 4 as two fuse=2 sweeps
DIMS4, BD4, ST4, FUSE4 = (16, 64, 128, 512), (4, 8, 8, 512), 4, 2
DIMS4_TINY, BD4_TINY = (8, 8, 8, 16), (4, 4, 4, 16)
# the strong step: bench.py's strong leg, 512^3 as 16 x (128, 128, 512)
SDOM = (N_BIG // 4, N_BIG // 4, N_BIG)
# the 2-D path: bench.py's 2-D leg (bench.py:316-334), 16384^2 as
# whole-row bricks (32, 16384), one fuse=4 sweep per step
N2, BY2, ST2, FUSE2 = 16384, 32, 4, 4
STEPS2, WAVE_STEPS = 25, 3
# the small Problem legs over K1 and K4
DIMS3_P, DIMS4_P = (64, 64, 512), (8, 16, 16, 64)
# H100 SXM published peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def close(got, want, tol):
    """(abs-or-rel match at ``tol`` everywhere, max abs difference), on the
    card: the rule of the reference's ``compare_arrays``."""
    import torch

    diff = (got - want).abs()
    denom = torch.maximum(got.abs(), want.abs()).clamp_min(1e-300)
    ok = bool(((diff < tol) | (diff / denom < tol)).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``fn()``, from CUDA events over ``iters``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_toolchain() -> str:
    import torch

    card = card_line()
    from bricklib_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        tri = f"triton {triton.__version__} imports"
    except ImportError as e:
        tri = f"triton does not import ({e})"
    print(card)
    print(f"[1 toolchain] card {card}; torch {torch.__version__}; "
          f"torch.version.cuda {torch.version.cuda}; nvcc: {nvcc}; {tri}")
    return card


def phase_build() -> None:
    from bricklib_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"[2 build] {dt:.1f} s -> {lib.relative_to(HERE)}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(f"    ptxas: {line.strip()}")


def decomposition(n: int):
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    return BrickDecomp(dims=(n, n, n), ghost_depth=(BD_K, BD_J, 0),
                       bdims=(BD_K, BD_J, n)).initialize(
        skinlist_by_name("good", 3))


def sweep_cases(dec):
    """The three K1 configurations: bench.py's k7 form, and the honest
    step's ghost-inclusive and owned-only fused sweeps."""
    GK, GJ = dec.grid.shape[:2]
    return [("fuse=1 periodic skip", dec.periodic_grid((0, 1, 2)),
             (1, GK - 1), (1, GJ - 1), 1),
            ("fuse=4 ghost-inclusive", dec.grid, (0, GK), (0, GJ), FUSE),
            ("fuse=4 skip", dec.grid, (1, GK - 1), (1, GJ - 1), FUSE)]


def make_sweep(dec, grid, kr, jr, fuse):
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

    return pencil_sweep(stencil_by_name("s7pt")[0], grid, dec.bdims,
                        dec.nbricks, bench_params(), k_range=kr,
                        j_range=jr, fuse=fuse)


def phase_kernels(sizes=(32, N_BIG)) -> dict:
    """Each kernel against its plain version; returns the largest abs
    error seen per kernel."""
    import torch

    from bricklib_tpu_torch.bench.roofline import (copy_storage,
                                                   copy_storage_plain)
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for n in sizes:
        dec = decomposition(n)
        x = random_storage(dec, seed=5, device="cuda")
        for name, grid, kr, jr, fuse in sweep_cases(dec):
            check_sweep(f"{n}^3 {name}", make_sweep(dec, grid, kr, jr, fuse),
                        x, err, "K1")
        for table_axes in ((2,), ()):
            ex = shift_exchange(dec, (1, 1, 1), table_axes)
            a, b = x.clone(), x.clone()
            ex(a)
            for ivs in ex.stages:
                copy_intervals_plain(b, ivs)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            moved = sum(d1 - d0 for st in ex.stages for d0, d1, _, _ in st)
            print(f"[3 K2 {n}^3 table_axes={table_axes}] "
                  f"{len(ex.stages)} stages, {moved} brick rows, "
                  f"{'bit-exact' if same else 'MISMATCH'}")
            if not same:
                fail(f"K2 {n}^3 disagrees with its plain version")
            del a, b
        y = copy_storage(x)
        same = torch.equal(y, copy_storage_plain(x))
        print(f"[3 K3 {n}^3] {x.numel() * 4 / 1e6:.1f} MB, "
              f"{'bit-exact' if same else 'MISMATCH'}")
        if not same:
            fail(f"K3 {n}^3 disagrees with its plain version")
        del x, y
        torch.cuda.empty_cache()
    return err


def decomposition_4d(dims, bd):
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    return BrickDecomp(dims=dims, ghost_depth=bd[:3] + (0,),
                       bdims=bd).initialize(skinlist_by_name("good", 4))


def sweep_cases_4d(dec):
    """The four K4 configurations: fuse 1 on the periodic table, and
    ghost-inclusive and owned-only sweeps at fuse 1 and 2."""
    G = dec.grid.shape[:3]
    ghost = dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2]))
    return [("fuse=1 periodic skip", dec.periodic_grid((0, 1, 2, 3)), {}, 1),
            ("fuse=1 ghost-inclusive", dec.grid, ghost, 1),
            ("fuse=2 ghost-inclusive", dec.grid, ghost, FUSE4),
            ("fuse=2 skip", dec.grid, {}, FUSE4)]


def make_sweep_4d(dec, grid, ranges, fuse):
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import pencil_sweep_4d
    from bricklib_tpu_torch.stencils import bench_params

    return pencil_sweep_4d("mpi9pt", grid, dec.bdims, dec.nbricks,
                           bench_params(), fuse=fuse, **ranges)


def check_sweep(name, fn, x, err, key):
    """One sweep (K1 or K4) against the plain version on the bricks it
    writes; records the largest abs error under ``key``."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    got = fn(x)
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).cuda(),
                              fn.plan)
    torch.cuda.synchronize()
    w = torch.from_numpy(fn.plan.written_bricks()).cuda()
    ok, e = close(got[w], want[w], K1_TOL)
    err[key] = max(err.get(key, 0.0), e)
    print(f"[3 {key} {name}] max abs err {e:.3e} (abs-or-rel {K1_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{key} {name} disagrees with its plain version")


def phase_kernels_4d(err: dict) -> None:
    """K4 against its plain version at the tiny and the full 4-D shape."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel_4d import tile_4d
    from bricklib_tpu_torch.core import random_storage

    for dims, bd in ((DIMS4_TINY, BD4_TINY), (DIMS4, BD4)):
        dec = decomposition_4d(dims, bd)
        x = random_storage(dec, seed=6, device="cuda")
        for name, grid, ranges, fuse in sweep_cases_4d(dec):
            fn = make_sweep_4d(dec, grid, ranges, fuse)
            tw, ti, smem = tile_4d(fn.plan)
            check_sweep(f"{dims} {name} tile w{tw} i{ti} {smem} B", fn, x,
                        err, "K4")
        del x
        torch.cuda.empty_cache()


def strong_plan():
    from bricklib_tpu_torch.comm import StrongDecomp, skinlist_by_name

    return StrongDecomp(dom=(N_BIG,) * 3, sdom=SDOM, mesh_shape=(1, 1, 1),
                        bdims=(BD_K, BD_J, N_BIG),
                        ghost_depth=(BD_K, BD_J, 0)).initialize(
        skinlist_by_name("good", 3))


def strong_sweeps(plan):
    """The strong step's two batched K1 sweeps: ghost-inclusive and
    owned-only, fuse=4 over the 16 subdomains."""
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params

    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    kw = dict(batch=nsub, batch_stride=nb, fuse=FUSE)
    GK, GJ = kg.shape[:2]
    return [(f"batched x{nsub} fuse=4 ghost-inclusive",
             pencil_sweep("s7pt", kg, plan.bdims, nsub * nb, bench_params(),
                          k_range=(0, GK), j_range=(0, GJ), **kw)),
            (f"batched x{nsub} fuse=4 skip",
             pencil_sweep("s7pt", kg, plan.bdims, nsub * nb, bench_params(),
                          **kw))]


def phase_kernels_strong(err: dict) -> None:
    """Batched K1 at the strong shape, and K5 bit-exact on every (stage,
    sign) of the full strong plan."""
    import torch

    from bricklib_tpu_torch.comm.strong import (stage_copy,
                                                stage_copy_plain,
                                                strong_stages)
    from bricklib_tpu_torch.core import random_array

    plan = strong_plan()
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    flat = torch.from_numpy(random_array(
        (nsub * nb,) + tuple(plan.bdims), "float32", 8)).cuda()
    for name, fn in strong_sweeps(plan):
        check_sweep(name, fn, flat, err, "K1")
    a, b = flat.clone(), flat.clone()
    for st in strong_stages(plan):
        gather = torch.from_numpy(st.gather).cuda()
        ra = a.index_select(0, gather) if st.recv_ivs else None
        rb = b.index_select(0, gather) if st.recv_ivs else None
        stage_copy(a, st.local_ivs, ra, st.recv_ivs)
        stage_copy_plain(b, st.local_ivs, rb, st.recv_ivs)
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        rows = sum(d1 - d0 for d0, d1, _, _ in st.local_ivs + st.recv_ivs)
        print(f"[3 K5 strong stage axis {st.axis} sign {st.sign:+d}] "
              f"{len(st.local_ivs)} local + {len(st.recv_ivs)} received "
              f"intervals, {rows} brick rows, "
              f"{'bit-exact' if same else 'MISMATCH'}")
        if not same:
            fail(f"K5 axis {st.axis} sign {st.sign} disagrees with its "
                 "plain version")
    if torch.equal(a, flat):
        fail("the strong exchange moved nothing")
    err["K5"] = 0.0


def stencil_2d(name: str):
    """A 2-D stencil of ``tests/torch_2d_stencils.py`` in the port's eDSL:
    ``box9`` (bench.py's 2-D stencil, bench.py:318-327), ``wave`` (the
    system of examples/wave_2d.py:48-59) or ``asym9`` (radius 2, asymmetric
    in both axes: it reaches the edge clamps)."""
    tests = str(HERE / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_2d_stencils import BUILDERS

    from bricklib_tpu_torch import st

    return BUILDERS[name](st)


def roll2(a, dy: int, dx: int):
    """``a[y + dy, x + dx]`` on the periodic domain."""
    import torch

    return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))


def box9_twin(a, n: int):
    """``n`` iterations of the 9-point box on a dense periodic array."""
    for _ in range(n):
        a = (0.4 * a
             + 0.1 * (roll2(a, 0, 1) + roll2(a, 0, -1) + roll2(a, 1, 0)
                      + roll2(a, -1, 0))
             + 0.02 * (roll2(a, 1, 1) + roll2(a, 1, -1) + roll2(a, -1, 1)
                       + roll2(a, -1, -1)))
    return a


def wave_twin(p, v, n: int):
    """``n`` steps of the wave system on dense periodic arrays."""
    for _ in range(n):
        lap = (roll2(p, 0, 1) + roll2(p, 0, -1) + roll2(p, 1, 0)
               + roll2(p, -1, 0) - 4.0 * p)
        p, v = p + v + 0.2 * lap, v + 0.2 * lap
    return p, v


def table_2d(gy: int, periodic: bool):
    """A 1-D row table of ``gy`` bricks, as bench.py builds it
    (bench.py:329-331): with ``periodic`` its two ghost rows point at the
    far owned rows."""
    import numpy as np

    from bricklib_tpu_torch.core import init_grid

    grid, info = init_grid((gy, 1))
    t = np.asarray(grid)[:, 0].copy()
    if periodic:
        t[0], t[-1] = t[-2], t[1]
    return t, info.nbricks


def rand_cuda(shape, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda")


def sweeps_2d():
    """K6's configurations: (name, fn, input shape), the first two at the
    2-D path's full storage (bench.py's 9-point box on the periodic
    table), then the wave system there, then a radius-2 stencil through
    the clamps of a non-periodic table."""
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d

    t, nb = table_2d(N2 // BY2 + 2, True)
    tiny, nbt = table_2d(6, False)
    box9, wave, asym9 = (stencil_2d(n) for n in ("box9", "wave", "asym9"))
    full = (nb, BY2, N2)
    return [
        ("box9 16384^2 fuse=1", pencil_sweep_2d(box9, t, (BY2, N2), nb),
         full),
        ("box9 16384^2 fuse=4", pencil_sweep_2d(box9, t, (BY2, N2), nb,
                                                fuse=FUSE2), full),
        ("wave 16384^2 fuse=1", pencil_sweep_2d(wave, t, (BY2, N2), nb),
         full),
        ("radius-2 6x(8,256) y_range=(0,6) fuse=1",
         pencil_sweep_2d(asym9, tiny, (8, 256), nbt, y_range=(0, 6)),
         (nbt, 8, 256)),
        ("radius-2 6x(8,256) y_range=(0,6) fuse=2",
         pencil_sweep_2d(asym9, tiny, (8, 256), nbt, y_range=(0, 6),
                         fuse=2), (nbt, 8, 256)),
    ]


def phase_kernels_2d(err: dict) -> None:
    """K6 against its plain version on every configuration of
    :func:`sweeps_2d`, on the bricks it writes."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_plain)

    for name, fn, shape in sweeps_2d():
        xs = [rand_cuda(shape, 20 + f) for f in range(len(fn.plan.fields))]
        got = fn(*xs)
        got = got if isinstance(got, tuple) else (got,)
        want = pencil_sweep_2d_plain(
            xs, torch.from_numpy(fn.plan.table).cuda(), fn.plan)
        torch.cuda.synchronize()
        w = torch.from_numpy(fn.plan.written_bricks()).cuda()
        tx, smem = fn.plan.tile()
        for o, (g, wv) in enumerate(zip(got, want)):
            ok, e = close(g[w], wv[w], K1_TOL)
            err["K6"] = max(err.get("K6", 0.0), e)
            print(f"[3 K6 {name} output {o} tile {tx} cols {smem} B] max abs "
                  f"err {e:.3e} (abs-or-rel {K1_TOL:g}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"K6 {name} output {o} disagrees with its plain version")
        del xs, got, want
        torch.cuda.empty_cache()


def counters():
    from bricklib_tpu_torch.bench.roofline import copy_storage
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_kernel)
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        pencil_sweep_4d_kernel)
    from bricklib_tpu_torch.comm.exchange import copy_intervals
    from bricklib_tpu_torch.comm.strong import stage_copy

    return {"K1": pencil_sweep_kernel, "K2": copy_intervals,
            "K3": copy_storage, "K4": pencil_sweep_4d_kernel,
            "K5": stage_copy, "K6": pencil_sweep_2d_kernel}


def drive(name: str, run, want_of):
    """Set every launch count to 0, drive one path, read the counts, and
    fail unless each kernel the path runs (``want_of(result)``: kernel ->
    expected launches, each above 0) launched exactly as expected and the
    others not at all."""
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    res = run()
    launches = {k: w.launches for k, w in wrappers.items()}
    path = want_of(res)
    want = {k: path.get(k, 0) for k in wrappers}
    print(f"[4 {name}] validated; calls {res['calls']}; launches "
          f"{launches}; expected {want}")
    for k in wrappers:
        if launches[k] != want[k] or path.get(k) == 0:
            fail(f"{name}: {k} launched {launches[k]} times, expected "
                 f"{want[k]}")
    return res, launches


def phase_paths(card: str) -> dict:
    """The port's three paths at full size, each through its driver;
    returns the launches per kernel summed over the three runs."""
    from bricklib_tpu_torch.comm.exchange import shift_stages
    from bricklib_tpu_torch.drivers import strong, weak

    # K2 launches once per exchange stage; the i axis goes through the table
    n3, n4 = (len(shift_stages(dec, (1,) * nd, (nd - 1,)))
              for dec, nd in ((decomposition(N_BIG), 3),
                              (decomposition_4d(DIMS4, BD4), 4)))
    paths = [
        ("weak 512^3", lambda: weak.run(
            dims=(N_BIG,) * 3, bdim=(BD_K, BD_J, N_BIG), stencil="s7pt",
            st_iter=ST_ITER, fuse=FUSE, table_periodic=False,
            backend="pencil", validate=True, device="cuda"),
         lambda r: {"K1": (ST_ITER // FUSE) * (r["calls"]["step"]
                                               + r["calls"]["step_noex"]),
                    "K2": n3 * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("weak 4-D", lambda: weak.run(
            dims=DIMS4, bdim=BD4, stencil="mpi9pt", st_iter=ST4,
            fuse=FUSE4, table_periodic=False, backend="pencil",
            validate=True, device="cuda"),
         lambda r: {"K4": (ST4 // FUSE4) * (r["calls"]["step"]
                                            + r["calls"]["step_noex"]),
                    "K2": n4 * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("strong 512^3", lambda: strong.run(
            dom=(N_BIG,) * 3, sdom=SDOM, bdim=(BD_K, BD_J, N_BIG),
            stencil="s7pt", st_iter=ST_ITER, fuse=FUSE, validate=True,
            device="cuda"),
         lambda r: {"K1": (ST_ITER // FUSE) * r["calls"]["step"],
                    "K5": r["exchange_steps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 2-D 16384^2 box9", problem_box9,
         lambda r: {"K6": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 2-D 16384^2 wave system", problem_wave,
         lambda r: {"K6": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 3-D s7pt", lambda: problem_nd(DIMS3_P, "s7pt", 4, 4),
         lambda r: {"K1": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 4-D mpi9pt", lambda: problem_nd(DIMS4_P, "mpi9pt", 2, 2),
         lambda r: {"K4": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
    ]
    total = dict.fromkeys(counters(), 0)
    for name, run, want_of in paths:
        res, launches = drive(name, run, want_of)
        report(card, name, res)
        for k in total:
            total[k] += launches[k]
    return total


def run_problem(p, init: dict, twin: dict, n_valid: int, n_timed: int):
    """Drive one ``Problem``: ``init``, ``n_valid`` steps held against
    ``twin`` (field -> the dense result on the card) at abs-or-rel 1e-4 on
    the owned region, a warm-up step and ``n_timed`` steps timed with CUDA
    events, then the copy speed of light of its state (K3, every field).
    Returns what :func:`report` prints and the calls made."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.bench.roofline import chain, copy_storage

    p.init(**init).step(n_valid)
    got = p.result()
    got = got if isinstance(got, dict) else {p.fields[0]: got}
    for f, want in twin.items():
        ok, e = close(torch.from_numpy(got[f]).cuda(), want, 1e-4)
        print(f"[4 Problem {p.dims} field {f}] {n_valid} step(s) against "
              f"the dense twin: max abs err {e:.3e} (abs-or-rel 1e-4) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"Problem {p.dims} field {f} disagrees with its dense twin")
        if not bool(torch.isfinite(want).all()):
            fail(f"Problem {p.dims} field {f}: the twin is not finite")
    del got
    p.step(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p.step(n_timed)
    end.record()
    end.synchronize()
    t_step = start.elapsed_time(end) / 1e3 / n_timed
    t_copy, _ = chain(lambda _x: [copy_storage(d) for d in p._dats][0],
                      p._dats[0], n_timed)
    nbytes = sum(d.numel() * d.element_size() for d in p._dats)
    elems = int(np.prod(p.dims))
    desc = p.describe()
    print(f"[4 Problem {p.dims}] describe: backend {desc['backend']}, "
          f"bdims {desc['bdims']}, fuse {desc['fuse']}, exchange "
          f"{desc['exchange']}, kernels {desc['kernels']}")
    return {"step": t_step, "gstencil_s": elems * p.st_iter / t_step / 1e9,
            "copy": t_copy, "copy_gbs": 2 * nbytes / t_copy / 1e9,
            "vs_copy_sol": p.st_iter * t_copy / t_step,
            "sweeps": p.st_iter // p.fuse,
            "calls": {"step": n_valid + 1 + n_timed,
                      "copy": len(p._dats) * (n_timed + 1)}}


def problem_box9():
    """The 2-D path: ``Problem`` at 16384^2 with bench.py's 9-point box,
    which must resolve to the pencil backend, bricks (32, 16384), fuse 4."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(N2, N2), stencil=stencil_2d("box9"), st_iter=ST2)
    if (p.backend, p.bdims, p.fuse) != ("pencil", (BY2, N2), FUSE2):
        fail(f"Problem 2-D resolved to {p.backend} {p.bdims} fuse {p.fuse}")
    g = rand_cuda((N2, N2), 31)
    twin = {"in": box9_twin(g, ST2)}
    return run_problem(p, {"array": g.cpu().numpy()}, twin, 1, STEPS2)


def problem_wave():
    """The wave system through ``Problem`` at 16384^2 (fuse 1, systems
    take no fusion), ``WAVE_STEPS`` validated steps."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(N2, N2), stencil=stencil_2d("wave"), field=("p", "v"))
    pv = {"p": rand_cuda((N2, N2), 32), "v": rand_cuda((N2, N2), 33)}
    tp, tv = wave_twin(pv["p"], pv["v"], WAVE_STEPS)
    init = {"array": {k: a.cpu().numpy() for k, a in pv.items()}}
    del pv
    return run_problem(p, init, {"p": tp, "v": tv}, WAVE_STEPS, 10)


def problem_nd(dims, name: str, st_iter: int, fuse: int):
    """A small ``Problem`` over K1 (3-D) or K4 (4-D), validated against
    the port's dense numpy twin (``dense_apply`` on wrap-padded
    arrays)."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.api import Problem
    from bricklib_tpu_torch.codegen.jnp_backend import dense_apply
    from bricklib_tpu_torch.core import random_array
    from bricklib_tpu_torch.stencils import stencil_by_name

    p = Problem(dims=dims, stencil=name, st_iter=st_iter)
    if (p.backend, p.fuse) != ("pencil", fuse):
        fail(f"Problem {dims} resolved to {p.backend} fuse {p.fuse}")
    sd = stencil_by_name(name)[0]
    g = random_array(dims, np.float32, 12)
    lo, hi = sd.radius()
    want = g
    for _ in range(st_iter):
        padded = np.pad(want, list(zip(lo, hi)), mode="wrap")
        want = dense_apply(sd, {p.gname: padded}, p.params, xp=np)
    return run_problem(p, {"array": g}, {p.gname: torch.from_numpy(
        np.ascontiguousarray(want, np.float32)).cuda()}, 1, 25)


def report(card: str, name: str, res: dict) -> None:
    extra = (f", exchange share {res['exchange'] / res['step'] * 100:.1f}%"
             if "exchange" in res else "")
    print(f"[5 {name} step] {card}: {res['step'] * 1e3:.3f} ms/step, "
          f"{res['gstencil_s']:.3f} GStencil/s{extra}")
    print(f"[5 {name} copy] {card}: K3 copy {res['copy'] * 1e3:.3f} ms, "
          f"{res['copy_gbs']:.1f} GB/s; step at {res['vs_copy_sol']:.4f} "
          f"of the copy speed of light per iteration")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` through device memory and do ``flops`` f32 operations."""
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def row(ms, plain_ms, nbytes, flops, library_ms) -> dict:
    b_ms, b_by = bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def sweep_work(plan) -> tuple[int, int]:
    """(bytes, f32 operations) one sweep (K1, K4 or K6) must move and do:
    each brick it reads through the table (the output bricks and their
    neighbours, whole) read once per input field, each brick it writes
    written once per output, and a multiply and an add per folded tap,
    output element and fused level."""
    import numpy as np

    t = plan.table
    if hasattr(plan, "y_range"):
        ranges, nin, nout = (plan.y_range,), len(plan.fields), len(plan.taps)
        ntaps, batch, stride = sum(len(x) for x in plan.taps), 1, 0
    else:
        ranges, nin, nout = plan.ranges, 1, 1
        ntaps = len(plan.taps.coeffs)
        batch, stride = plan.batch, plan.batch_stride
    win = t[tuple(slice(max(a - 1, 0), min(b + 1, n))
                  for (a, b), n in zip(ranges, t.shape))]
    nread = len(np.unique(np.concatenate(
        [win.ravel() + s * stride for s in range(batch)])))
    nwritten = len(plan.written_bricks())
    belems = int(np.prod(plan.bdims))
    return (4 * belems * (nin * nread + nout * nwritten),
            2 * ntaps * plan.fuse * nwritten * belems)


def phase_times(card: str) -> dict:
    """Per kernel: its ms beside its plain version's, its bound and, where
    one PyTorch call computes the same function, that call's ms; at the
    paths' shapes: K1 and K2 summed over the launches of one 512^3 step
    (two sweeps, two exchange stages), K3 per whole-storage copy."""
    import torch

    from bricklib_tpu_torch.bench.roofline import (copy_storage,
                                                   copy_storage_plain)
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    dec = decomposition(N_BIG)
    x = random_storage(dec, seed=9, device="cuda")
    out = {"K1": time_sweeps(card, "K1", [
        (name, make_sweep(dec, grid, kr, jr, fuse))
        for name, grid, kr, jr, fuse in sweep_cases(dec)[1:]], x)}
    ex = shift_exchange(dec, (1, 1, 1), (2,))
    ex(x)
    brick = x[0].numel() * x.element_size()

    def plain_ex():
        for ivs in ex.stages:
            copy_intervals_plain(x, ivs)

    lib = [(interval_rows(ivs, 0), interval_rows(ivs, 2))
           for ivs in ex.stages]

    def lib_ex():
        for d, s in lib:
            x[d] = x[s]

    moved = sum(d1 - d0 for ivs in ex.stages for d0, d1, _, _ in ivs)
    out["K2"] = row(cuda_ms(lambda: ex(x), 50), cuda_ms(plain_ex, 50),
                    2 * moved * brick, 0, cuda_ms(lib_ex, 50))
    y = torch.empty_like(x)
    out["K3"] = row(cuda_ms(lambda: copy_storage(x), 50),
                    cuda_ms(lambda: copy_storage_plain(x), 50),
                    2 * x.numel() * x.element_size(), 0,
                    cuda_ms(lambda: y.copy_(x), 50))
    for k in ("K2", "K3"):
        print_times(card, k, "", out[k])
    del x, y
    torch.cuda.empty_cache()
    out.update(phase_times_4d(card))
    out.update(phase_times_strong(card))
    out.update(phase_times_2d(card))
    return out


def interval_rows(ivs, k: int):
    """The rows ``[iv[k], iv[k + 1])`` of every copy interval, as one
    index tensor on the card: ``k`` 0 for destinations, 2 for sources."""
    import torch

    return torch.tensor([r for iv in ivs
                         for r in range(iv[k], iv[k + 1])]).cuda()


def print_times(card: str, key: str, name: str, r: dict) -> None:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.3f} ms")
    print(f"[5 {key}{' ' + name if name else ''}] {card}: kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}), library call {lib}")


def time_sweeps(card: str, key: str, cases, x) -> dict:
    """:func:`row` of sweeps (K1 or K4) summed over ``cases``; no single
    PyTorch call computes a fused sweep over brick storage."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    tot = [0.0, 0.0, 0, 0]
    for name, fn in cases:
        table = torch.from_numpy(fn.plan.table).cuda()
        nbytes, flops = sweep_work(fn.plan)
        r = row(cuda_ms(lambda: fn(x), 20),
                cuda_ms(lambda: pencil_sweep_plain(x, table, fn.plan), 3),
                nbytes, flops, None)
        print_times(card, key, name, r)
        tot = [tot[0] + r["ms"], tot[1] + r["plain_ms"], tot[2] + nbytes,
               tot[3] + flops]
    return row(*tot, None)


def phase_times_4d(card: str) -> dict:
    """K4 summed over the 4-D step's two sweeps."""
    import torch

    from bricklib_tpu_torch.core import random_storage

    dec = decomposition_4d(DIMS4, BD4)
    x = random_storage(dec, seed=10, device="cuda")
    cases = [(name, make_sweep_4d(dec, grid, ranges, fuse))
             for name, grid, ranges, fuse in sweep_cases_4d(dec)[2:]]
    out = {"K4": time_sweeps(card, "K4", cases, x)}
    del x
    torch.cuda.empty_cache()
    return out


def phase_times_strong(card: str) -> dict:
    """Batched K1 over the strong step's two sweeps, and K5 summed over
    the launches of one strong exchange (receive buffers gathered
    beforehand); K5's library call is an indexed assignment of the same
    rows per (stage, sign) and source (storage, receive buffer)."""
    import torch

    from bricklib_tpu_torch.comm.strong import (stage_copy,
                                                stage_copy_plain,
                                                stage_table, strong_stages)
    from bricklib_tpu_torch.core import random_array

    plan = strong_plan()
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    flat = torch.from_numpy(random_array(
        (nsub * nb,) + tuple(plan.bdims), "float32", 11)).cuda()
    out = {"K1 batched": time_sweeps(card, "K1", strong_sweeps(plan), flat)}
    steps, lib, nrows = [], [], 0
    for st in strong_stages(plan):
        recv = (flat.index_select(0, torch.from_numpy(st.gather).cuda())
                if st.recv_ivs else None)
        steps.append((st, recv, stage_table(st.local_ivs, st.recv_ivs,
                                            flat)))
        for ivs, src in ((st.local_ivs, flat), (st.recv_ivs, recv)):
            if ivs:
                lib.append((interval_rows(ivs, 0), src,
                            interval_rows(ivs, 2)))
                nrows += sum(d1 - d0 for d0, d1, _, _ in ivs)

    def kernel():
        for st, recv, table in steps:
            stage_copy(flat, st.local_ivs, recv, st.recv_ivs, table)

    def plain():
        for st, recv, _table in steps:
            stage_copy_plain(flat, st.local_ivs, recv, st.recv_ivs)

    def library():
        for d, src, s in lib:
            flat[d] = src[s]

    brick = flat[0].numel() * flat.element_size()
    out["K5"] = row(cuda_ms(kernel, 50), cuda_ms(plain, 50),
                    2 * nrows * brick, 0, cuda_ms(library, 50))
    print_times(card, "K5", f"per exchange, {len(steps)} launches",
                out["K5"])
    del flat, steps, lib
    torch.cuda.empty_cache()
    return out


def conv_of(plan, fuse: int):
    """``nn.Conv2d`` (circular padding, no bias) computing what one sweep
    of ``plan`` computes on a periodic domain: per output and input field,
    the ``fuse``-fold composition of the output's folded taps as
    weights."""
    import torch

    comps = []
    for taps in plan.taps:
        one = dict(taps)
        comp = dict(one)
        for _ in range(fuse - 1):
            nxt: dict = {}
            for (f, a, b), c in comp.items():
                for (_f, dy, dx), d in one.items():
                    k = (f, a + dy, b + dx)
                    nxt[k] = nxt.get(k, 0.0) + c * d
            comp = nxt
        comps.append(comp)
    R = max(max(abs(dy), abs(dx)) for comp in comps for _f, dy, dx in comp)
    w = torch.zeros(len(comps), len(plan.fields), 2 * R + 1, 2 * R + 1,
                    dtype=torch.float64)
    for o, comp in enumerate(comps):
        for (f, dy, dx), c in comp.items():
            w[o, f, dy + R, dx + R] = c
    conv = torch.nn.Conv2d(len(plan.fields), len(comps), 2 * R + 1,
                           padding=R, padding_mode="circular", bias=False,
                           device="cuda").requires_grad_(False)
    conv.weight.copy_(w.float())
    return conv


def phase_times_2d(card: str) -> dict:
    """K6 on each 16384^2 configuration of :func:`sweeps_2d`: kernel,
    plain version, bound, and one ``nn.Conv2d`` call on the owned rows as
    a dense periodic array (checked against the kernel at 1e-4 before it
    is timed).  The ``fuse=4`` 9-point box, the 2-D path's sweep, is the
    kernel's record."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_plain)

    out = {}
    for name, fn, shape in sweeps_2d()[:3]:
        plan = fn.plan
        xs = [rand_cuda(shape, 40 + f) for f in range(len(plan.fields))]
        table = torch.from_numpy(plan.table).cuda()
        t_k = cuda_ms(lambda: fn(*xs), 20)
        t_p = cuda_ms(lambda: pencil_sweep_2d_plain(xs, table, plan), 3)
        ids = table[plan.y_range[0]:plan.y_range[1]].long()
        dense = torch.stack([x[ids].reshape(-1, N2) for x in xs])[None]
        got = fn(*xs)
        got = got if isinstance(got, tuple) else (got,)
        t_l = None
        try:
            with torch.no_grad():
                conv = conv_of(plan, plan.fuse)
                ref = conv(dense)[0]
                same = all(close(g[ids].reshape(-1, N2), r, 1e-4)[0]
                           for g, r in zip(got, ref))
                del ref
                if same:
                    t_l = cuda_ms(lambda: conv(dense), 5)
                else:
                    print(f"[5 K6 {name}] nn.Conv2d disagrees with the "
                          "kernel at 1e-4: no library time")
        except RuntimeError as e:
            print(f"[5 K6 {name}] nn.Conv2d failed ({e}): no library time")
        r = row(t_k, t_p, *sweep_work(plan), t_l)
        print_times(card, "K6", name, r)
        if name.startswith("box9") and plan.fuse == FUSE2:
            out["K6"] = r
        del xs, dense, got
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not (HERE / "bricklib_tpu_torch" / "csrc").is_dir():
        fail(f"no bricklib_tpu_torch/ beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_toolchain()
    phase_build()
    err = phase_kernels()
    phase_kernels_4d(err)
    phase_kernels_strong(err)
    phase_kernels_2d(err)
    launches = phase_paths(card)
    times = phase_times(card)
    if "jax" in sys.modules:
        fail("the port imported jax")
    ref_mods = sorted(m for m in sys.modules if m == "bricklib_tpu"
                      or m.startswith("bricklib_tpu."))
    if ref_mods:
        fail(f"the port imported the JAX package: {ref_mods}")
    src = "bricklib_tpu_torch/csrc/"
    kernels = [
        ("K1", {"name": "K1 pencil_sweep", "route": "cuda",
                "source": src + "pencil_sweep.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel.py:296"}),
        ("K2", {"name": "K2 copy_intervals", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/comm/exchange.py:138"}),
        ("K3", {"name": "K3 copy_storage", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/bench/roofline.py:154"}),
        ("K4", {"name": "K4 pencil_sweep_4d", "route": "cuda",
                "source": src + "pencil_sweep_4d.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel_4d.py:48"}),
        ("K5", {"name": "K5 copy_stage", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/comm/strong.py:133"}),
        ("K6", {"name": "K6 pencil_sweep_2d", "route": "cuda",
                "source": src + "pencil_sweep_2d.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel_2d.py:42"}),
    ]
    for k, entry in kernels:
        entry.update(launches=launches[k], max_abs_err=err[k], **times[k])
    print(json.dumps({"kernels": [e for _k, e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
