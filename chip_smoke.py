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
   sweep) at a tiny and the full 4-D shape in four configurations, all at
   abs-or-rel 1e-5 (FMA contraction and summation order); K2 (exchange
   interval copies), K3 (storage copy) and K5 (strong exchange stage, on
   every (stage, sign) of the full strong plan) bit-exact;
4. drives three paths through their drivers, each validated against its
   dense numpy twin at 1e-4 and timed: the honest 512^3 weak step (SHIFT
   exchange + two fuse=4 s7pt sweeps, ``drivers.weak``), the 4-D weak step
   (16x64x128x512, mpi9pt, SHIFT exchange + two fuse=2 sweeps,
   ``drivers.weak``) and the one-card strong step (512^3 as 16 subdomains
   of 128x128x512, s7pt, strong exchange + two batched fuse=4 sweeps,
   ``drivers.strong``);
5. checks from the launch counters, set to 0 just before each path and
   read just after, that each path ran through its kernels;
6. times each kernel beside its plain version at the paths' shapes.

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


def counters():
    from bricklib_tpu_torch.bench.roofline import copy_storage
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        pencil_sweep_4d_kernel)
    from bricklib_tpu_torch.comm.exchange import copy_intervals
    from bricklib_tpu_torch.comm.strong import stage_copy

    return {"K1": pencil_sweep_kernel, "K2": copy_intervals,
            "K3": copy_storage, "K4": pencil_sweep_4d_kernel,
            "K5": stage_copy}


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
    ]
    total = dict.fromkeys(counters(), 0)
    for name, run, want_of in paths:
        res, launches = drive(name, run, want_of)
        report(card, name, res)
        for k in total:
            total[k] += launches[k]
    return total


def report(card: str, name: str, res: dict) -> None:
    extra = (f", exchange share {res['exchange'] / res['step'] * 100:.1f}%"
             if "exchange" in res else "")
    print(f"[5 {name} step] {card}: {res['step'] * 1e3:.3f} ms/step, "
          f"{res['gstencil_s']:.3f} GStencil/s{extra}")
    print(f"[5 {name} copy] {card}: K3 copy {res['copy'] * 1e3:.3f} ms, "
          f"{res['copy_gbs']:.1f} GB/s; step at {res['vs_copy_sol']:.4f} "
          f"of the copy speed of light per iteration")


def phase_times(card: str) -> dict:
    """(kernel ms, plain ms) at the step's 512^3 shapes: K1 and K2 summed
    over the launches of one step (two sweeps, two exchange stages), K3
    per whole-storage copy."""
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

    def plain_ex():
        for ivs in ex.stages:
            copy_intervals_plain(x, ivs)

    out["K2"] = [cuda_ms(lambda: ex(x), 50), cuda_ms(plain_ex, 50)]
    out["K3"] = [cuda_ms(lambda: copy_storage(x), 50),
                 cuda_ms(lambda: copy_storage_plain(x), 50)]
    for k in ("K2", "K3"):
        print(f"[5 {k}] {card}: kernel {out[k][0]:.3f} ms, plain "
              f"{out[k][1]:.3f} ms")
    del x
    torch.cuda.empty_cache()
    out.update(phase_times_4d(card))
    out.update(phase_times_strong(card))
    return out


def time_sweeps(card: str, key: str, cases, x) -> list:
    """(kernel ms, plain ms) of sweeps summed over ``cases``."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    tot = [0.0, 0.0]
    for name, fn in cases:
        table = torch.from_numpy(fn.plan.table).cuda()
        t_k = cuda_ms(lambda: fn(x), 20)
        t_p = cuda_ms(lambda: pencil_sweep_plain(x, table, fn.plan), 3)
        tot[0] += t_k
        tot[1] += t_p
        print(f"[5 {key} {name}] {card}: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms")
    return tot


def phase_times_4d(card: str) -> dict:
    """K4 (kernel ms, plain ms) summed over the 4-D step's two sweeps."""
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
    beforehand): (kernel ms, plain ms)."""
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
    steps = []
    for st in strong_stages(plan):
        recv = (flat.index_select(0, torch.from_numpy(st.gather).cuda())
                if st.recv_ivs else None)
        steps.append((st, recv, stage_table(st.local_ivs, st.recv_ivs,
                                            flat)))

    def kernel():
        for st, recv, table in steps:
            stage_copy(flat, st.local_ivs, recv, st.recv_ivs, table)

    def plain():
        for st, recv, _table in steps:
            stage_copy_plain(flat, st.local_ivs, recv, st.recv_ivs)

    out["K5"] = [cuda_ms(kernel, 50), cuda_ms(plain, 50)]
    print(f"[5 K5 per exchange, {len(steps)} launches] {card}: kernel "
          f"{out['K5'][0]:.3f} ms, plain {out['K5'][1]:.3f} ms")
    del flat, steps
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
    launches = phase_paths(card)
    times = phase_times(card)
    if "jax" in sys.modules:
        fail("the port imported jax")
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
    ]
    for k, entry in kernels:
        entry.update(launches=launches[k], max_abs_err=err[k],
                     ms=times[k][0], plain_ms=times[k][1])
    print(json.dumps({"kernels": [e for _k, e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
