#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bricklib_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. records the toolchain (card name and power limit, torch, CUDA, nvcc,
   whether ``triton`` imports);
2. builds the port's CUDA kernels from ``bricklib_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card:
   K1 (fused pencil sweep) at 32^3 and 512^3 in three configurations at
   abs-or-rel 1e-5 (FMA contraction and summation order), K2 (exchange
   interval copies) and K3 (storage copy) bit-exact;
4. drives the honest 512^3 weak step (SHIFT exchange + two fuse=4 sweeps of
   s7pt) through ``bricklib_tpu_torch.drivers.weak.run``, which validates
   it against the dense numpy twin at 1e-4 and times it;
5. times each kernel beside its plain version at the step's shapes;
6. checks from the launch counters that the step ran through K1, K2, K3.

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
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for n in sizes:
        dec = decomposition(n)
        x = random_storage(dec, seed=5, device="cuda")
        for name, grid, kr, jr, fuse in sweep_cases(dec):
            fn = make_sweep(dec, grid, kr, jr, fuse)
            got = fn(x)
            table = torch.from_numpy(fn.plan.table).cuda()
            want = pencil_sweep_plain(x, table, fn.plan)
            torch.cuda.synchronize()
            w = torch.from_numpy(fn.plan.written_bricks()).cuda()
            ok, e = close(got[w], want[w], K1_TOL)
            err["K1"] = max(err["K1"], e)
            print(f"[3 K1 {n}^3 {name}] max abs err {e:.3e} "
                  f"(abs-or-rel {K1_TOL:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"K1 {n}^3 {name} disagrees with its plain version")
            del got, want
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


def counters():
    from bricklib_tpu_torch.bench.roofline import copy_storage
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
    from bricklib_tpu_torch.comm.exchange import copy_intervals

    return {"K1": pencil_sweep_kernel, "K2": copy_intervals,
            "K3": copy_storage}


def phase_slice(card: str):
    """The port's main path at full size; returns (run result, launches
    per kernel in that run)."""
    from bricklib_tpu_torch.drivers import weak

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    res = weak.run(dims=(N_BIG,) * 3, bdim=(BD_K, BD_J, N_BIG),
                   stencil="s7pt", st_iter=ST_ITER, fuse=FUSE,
                   table_periodic=False, backend="pencil", validate=True,
                   device="cuda")
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = res["calls"]
    want = {"K1": (ST_ITER // FUSE) * (calls["step"] + calls["step_noex"]),
            "K2": 2 * calls["step"], "K3": calls["copy"]}
    print(f"[4 slice] validated; calls {calls}; launches {launches}; "
          f"expected {want}")
    for k in wrappers:
        if launches[k] == 0 or launches[k] != want[k]:
            fail(f"{k} launched {launches[k]} times in the step's run, "
                 f"expected {want[k]}")
    print(f"[5 step] {card}: {res['step'] * 1e3:.3f} ms/step, "
          f"{res['gstencil_s']:.3f} GStencil/s, exchange share "
          f"{res['exchange'] / res['step'] * 100:.1f}%")
    print(f"[5 copy] {card}: K3 copy {res['copy'] * 1e3:.3f} ms, "
          f"{res['copy_gbs']:.1f} GB/s; step at {res['vs_copy_sol']:.4f} "
          f"of the copy speed of light per iteration")
    return res, launches


def phase_times(card: str) -> dict:
    """(kernel ms, plain ms) at the step's 512^3 shapes: K1 and K2 summed
    over the launches of one step (two sweeps, two exchange stages), K3
    per whole-storage copy."""
    import torch

    from bricklib_tpu_torch.bench.roofline import (copy_storage,
                                                   copy_storage_plain)
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    dec = decomposition(N_BIG)
    x = random_storage(dec, seed=9, device="cuda")
    out = {"K1": [0.0, 0.0]}
    for name, grid, kr, jr, fuse in sweep_cases(dec)[1:]:
        fn = make_sweep(dec, grid, kr, jr, fuse)
        table = torch.from_numpy(fn.plan.table).cuda()
        t_k = cuda_ms(lambda: fn(x), 20)
        t_p = cuda_ms(lambda: pencil_sweep_plain(x, table, fn.plan), 3)
        out["K1"][0] += t_k
        out["K1"][1] += t_p
        print(f"[5 K1 {name}] {card}: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms")
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
    _res, launches = phase_slice(card)
    times = phase_times(card)
    if "jax" in sys.modules:
        fail("the port imported jax")
    src = "bricklib_tpu_torch/csrc/"
    kernels = [
        {"name": "K1 pencil_sweep", "route": "cuda",
         "source": src + "pencil_sweep.cu",
         "replaces": "bricklib_tpu/codegen/pencil_kernel.py:296"},
        {"name": "K2 copy_intervals", "route": "cuda",
         "source": src + "brick_copy.cu",
         "replaces": "bricklib_tpu/comm/exchange.py:138"},
        {"name": "K3 copy_storage", "route": "cuda",
         "source": src + "brick_copy.cu",
         "replaces": "bricklib_tpu/bench/roofline.py:154"},
    ]
    for k, entry in zip(("K1", "K2", "K3"), kernels):
        entry.update(launches=launches[k], max_abs_err=err[k],
                     ms=times[k][0], plain_ms=times[k][1])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
