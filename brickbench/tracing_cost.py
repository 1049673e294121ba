"""What the program's tracing costs when on, in one cell: the host
milliseconds of a step call (``host_step_ms``'s stretch) and the traced
window's ``device_idle_pct``, each with the program's spans off and on,
in alternating turns (off, on, on, off, ...) in one process.

    python3 -m brickbench.tracing_cost --workload <name> [--turns 4]

Prints one JSON line: per setting the readings of every turn.  Needs the
program's tracing module (``bricklib_tpu_torch.trace``) and a card.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import trace
from .cell import build_system, load_cell
from .harness import Loop
from .timing import StepClock


def measure(cell, turns: int, device: str = "cuda") -> dict:
    """``{"off": {...}, "on": {...}}``: per setting, the host ms of each
    turn's step calls and the idle share of each turn's profiled window."""
    from bricklib_tpu_torch import trace as program

    system = build_system(cell, device)
    loop = Loop(system, 0, StepClock(system.devices))
    loop.run(steps=2 * loop.R, sample=False)
    system.sync()
    n, batches = int(cell.traffic["trace_steps"]), int(
        cell.traffic["host_batches"])
    out = {k: {"host_step_ms": [], "device_idle_pct": []}
           for k in ("off", "on")}
    for turn in range(turns):
        on = turn % 4 in (1, 2)
        if on:
            program.enable()
        try:
            host = loop.host_times(batches)

            def window():
                loop.run(steps=n, sample=False, annotate=True)
                system.sync()

            t = trace.profile(window, device == "cuda")
        finally:
            program.disable()
            program.records()
        k = out["on" if on else "off"]
        k["host_step_ms"].append(sum(host) / len(host) * 1e3)
        k["device_idle_pct"].append(
            (1 - t.busy_s() / t.window_s) * 100 if t.ops else None)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--turns", type=int, default=4)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tracing_cost: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    res = measure(load_cell(a.workload), a.turns)
    print(json.dumps({"workload": a.workload,
                      "device": torch.cuda.get_device_name(0), **res}),
          flush=True)


if __name__ == "__main__":
    main()
