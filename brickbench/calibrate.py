"""The readings a cell's limit is set from, at the cell's own sizes.

    python3 -m brickbench.calibrate --workload <name> --seeds 1,2,...
        [--control-seeds a,b,c] [--faults unchanged,half,altered,no_exchange]
        [--fault-seeds a,b,c]

In one process (the program is built once per fault): for each seed of
``--seeds`` the program's ``rel_err`` over as many answers as a run
compares (the lower reading is the largest); for each of
``--control-seeds`` the control's, the plain reference computed in
bfloat16 in the program's place (the upper reading is the smallest);
for each fault of :mod:`brickbench.faults` and seed of
``--fault-seeds`` the program's reading with the fault planted.  Each
reading is one JSON line.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import faults, fields, reference
from .cell import load_cell
from .harness import Loop, System, check
from .timing import StepClock


def program_reading(system: System, seed: int) -> dict:
    """``check`` of the first answers of a loop drawn from ``seed``."""
    loop = Loop(system, seed, StepClock(system.devices))
    loop.run(steps=loop.S * loop.R)
    system.sync()
    out = check(system, loop.keep, loop.kept, seed)
    del loop
    return out


def control_reading(cell, seed: int, device) -> float:
    """The control's widest relative gap: the reference in bfloat16
    against the reference in float32, over field 0 of ``seed``, on every
    rank's block."""
    iters = int(cell.traffic["problem_steps"]) * int(cell.config["st_iter"])
    f = fields.draw_field(cell.global_domain, seed, 0, device)
    want = reference.iterate(f, cell.taps, iters)
    got = reference.iterate(f, cell.taps, iters, dtype=torch.bfloat16)
    del f
    return max(reference.rel_err(
        fields.rank_block(got, np.unravel_index(r, cell.mesh), cell.domain),
        fields.rank_block(want, np.unravel_index(r, cell.mesh), cell.domain))
        for r in range(cell.ranks))


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)

    def emit(**kw):
        print(json.dumps(dict(workload=a.workload, **kw)), flush=True)

    if a.device == "cuda":
        emit(kind=torch.cuda.get_device_name(0))
    system = System(cell, a.device) if (a.seeds or a.faults) else None
    for seed in _ints(a.seeds):
        t0 = time.perf_counter()
        r = program_reading(system, seed)
        emit(reading="program", seed=seed, rel_err=r["rel_err"][0],
             answers=r["answers"], seconds=time.perf_counter() - t0)
    for seed in _ints(a.control_seeds):
        emit(reading="control", seed=seed,
             rel_err=control_reading(cell, seed, system.devices[0]
                                     if system else a.device))
    for name in [f for f in a.faults.split(",") if f]:
        if name == "no_exchange":
            del system
            with faults.no_exchange():
                system = System(cell, a.device)
        else:
            step = system.step
            faults.WRAPS[name](system)
        for seed in _ints(a.fault_seeds):
            r = program_reading(system, seed)
            emit(reading="fault", fault=name, seed=seed,
                 rel_err=r["rel_err"][0], answers=r["answers"])
        if name == "no_exchange":
            del system
            system = System(cell, a.device)
        else:
            system.step = step
    print("calibrate: done", file=sys.stderr)


if __name__ == "__main__":
    main()
