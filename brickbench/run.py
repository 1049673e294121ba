"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m brickbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a host stretch and a profiler
window after the measured window) and a breakdown of the trace.  Exits
with an error, printing no result, without CUDA or with fewer cards than
the cell needs, and if JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bricklib_tpu")


def _fail(msg: str, code: int = 2) -> None:
    print(f"brickbench: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that the
    run may not load, compared whole (``bricklib_tpu_torch`` is not
    ``bricklib_tpu``)."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)}
                  & set(FORBIDDEN))


def _number(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def main(argv=None) -> None:
    from .harness import process_age

    age = process_age()
    t_begin = time.perf_counter() - (age or 0.0)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "brickbench" /
                                        "cuda_cache")

    import torch

    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    from .cell import load_cell, metric_reader

    cell = load_cell(a.workload)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{a.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present")
    try:
        import bricklib_tpu_torch
    except ImportError as e:
        _fail(f"the program is not here: {e}", 3)
    if ROOT not in Path(bricklib_tpu_torch.__file__).resolve().parents:
        _fail(f"bricklib_tpu_torch comes from {bricklib_tpu_torch.__file__},"
              f" not from this checkout ({ROOT})", 3)
    from .harness import run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    rec, chk = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                        t_begin=t_begin, log=log)
    metrics = {}
    for m in cell.metrics(bool(a.trace)):
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": chk["ok"], "attempted": chk["answers"],
           "failed": chk["failed"],
           "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_mean_s()
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    err, limit = chk["rel_err"]
    out["checked"] = {"rel_err": {"value": _number(err), "limit": limit},
                      "answers": {"value": chk["answers"], "limit": 1}}
    log(f"steps {rec.steps} in {rec.window_s} s; answers {rec.answers}")
    log(f"check answers {chk['answers']} (limit: at least 1)")
    log(f"check rel_err {err!r} (limit {limit!r})")
    # last, after every reader has run: whatever loaded JAX counts
    bad = forbidden_modules()
    if bad:
        _fail(f"modules of JAX or the JAX package were loaded: {bad}", 4)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
