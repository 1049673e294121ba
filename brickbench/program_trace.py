"""The program's own spans and counters (``bricklib_tpu_torch.trace``),
read for the per-layer metrics whose source is ``program_span`` or
``program_counter``.

The harness's traced window runs with the program's tracing off, as it
always has.  So these metrics come from a pass of their own over the same
cell, made once per record after the run, when the run's state is freed:

1. the step is built again (:func:`~brickbench.cell.build_system`) with
   the program's tracing on: the ``bricklib.plan`` spans;
2. the harness's warm-up (two runs), tracing still on: the first step's
   ``bricklib.plan.kernels``;
3. the traffic's ``trace_steps`` steps of the harness's loop, with its
   marks, under ``torch.profiler`` inside a
   :data:`~brickbench.trace.WINDOW` mark and with the program's tracing
   on; the program's counters are read before and after.

Each device operation of the window is tied to the innermost ``bricklib.*``
span open at its launch, by correlation id.  The pass runs on the cards
where the run did (``memory_peak_bytes`` above 0), else on the CPU, where
the kernels' plain versions launch nothing.  Its fields are drawn from
seed 0: spans and counters do not depend on the values.  Where the
program has no tracing module, the pass is not made and every reading is
None.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

from . import trace
from .cell import build_system
from .timing import StepClock

PREFIX, PLAN = "bricklib.", "bricklib.plan"
EXCHANGE, SWEEP = "bricklib.exchange", "bricklib.sweep"


@dataclass
class ProgramTrace:
    """What the pass read: the window's ``steps`` and ``devices`` (the
    cards on which an operation ran; empty on the CPU), per span name the
    spans that began in the window (``spans``) and the device seconds of
    the operations launched with it innermost (``device_s``), the
    counters' changes over the window (``counters``), the host seconds of
    the set-up's spans (``plan_s``), whether the pass ran on cards, and
    the device seconds under the sweep spans by their kernel and region
    (``sweep_s``, e.g. ``"K1 ghost"``)."""

    steps: int
    cards: int
    cuda: bool
    devices: list
    spans: dict = field(default_factory=dict)
    device_s: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    plan_s: dict = field(default_factory=dict)
    sweep_s: dict = field(default_factory=dict)


def of(rec) -> ProgramTrace | None:
    """The pass over ``rec``'s cell (made on the first call, kept on the
    record), or None: no traced run, no cell, or no tracing module in the
    program."""
    if "program_trace" not in vars(rec):
        vars(rec)["program_trace"] = _measure(rec)
    return vars(rec)["program_trace"]


def _measure(rec) -> ProgramTrace | None:
    if rec.trace is None or rec.cell is None:
        return None
    try:
        from bricklib_tpu_torch import trace as program
    except ImportError:
        return None
    from .harness import Loop

    cuda = rec.memory_peak_bytes > 0
    program.records()
    with program.tracing():
        system = build_system(rec.cell, "cuda" if cuda else "cpu")
        plan = program.records()
        loop = Loop(system, 0, StepClock(system.devices))
        loop.run(steps=2 * loop.R, sample=False)
        system.sync()
        plan += program.records()
    n = int(rec.cell.traffic["trace_steps"])
    before, steps0 = program.counters(), loop.steps

    def window():
        loop.run(steps=n, sample=False, annotate=True)
        system.sync()

    with program.tracing():
        events = _profile(window, cuda)
    sweeps = [f"{s.args['kernel']} {s.args['region']}"
              for s in program.records() if s.name == SWEEP]
    after = program.counters()
    out = ProgramTrace(loop.steps - steps0, len(system.devices), cuda, [])
    out.counters = {k: after[k] - before[k] for k in after}
    for s in plan:
        if s.name.startswith(PLAN):
            out.plan_s[s.name] = out.plan_s.get(s.name, 0.0) + s.seconds
    _attribute(events, out, sweeps)
    summary = trace.summarize(events)
    print("program trace: " + json.dumps({
        "steps": out.steps, "spans": out.spans, "device_s": out.device_s,
        "sweep_s": out.sweep_s, "counters": out.counters,
        "plan_s": out.plan_s, "idle_gaps": summary.idle_gaps()}),
        file=sys.stderr, flush=True)
    return out


def _profile(fn, cuda: bool) -> list:
    """The Chrome trace events of ``fn()`` run under ``torch.profiler``
    inside a :data:`~brickbench.trace.WINDOW` mark."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _attribute(events, out: ProgramTrace, sweeps=()) -> None:
    """Fill ``out.spans`` (program spans begun in the window, by name),
    ``out.device_s`` (device seconds of the window's operations, clipped
    to it, by the name of the innermost program span open at their launch;
    ``""`` outside every span), ``out.devices`` and ``out.sweep_s`` (the
    sweep spans' share of ``device_s`` by ``sweeps``: the label of each
    sweep span in the order they opened, as the program recorded them)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next(e for e in xs if e.get("name") == trace.WINDOW
               and e.get("cat", "").lower() == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat", "").lower() == "user_annotation"
                   and e.get("name", "").startswith(PREFIX))
    starts = [s[0] for s in spans]
    label = {}
    for s, _e, name in spans:
        if w0 <= s <= w1:
            out.spans[name] = out.spans.get(name, 0) + 1
        if name == SWEEP and len(label) < len(sweeps):
            label[s] = sweeps[len(label)]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat", "").lower() in trace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    for e in xs:
        if e.get("cat", "").lower() not in trace.DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s0, e0 = max(s, w0), min(s + d, w1)
        if e0 <= s0:
            continue
        args = e.get("args", {})
        dev = int(args.get("device", e.get("pid", 0)))
        if dev not in out.devices:
            out.devices.append(dev)
        t = launches.get(args.get("correlation"))
        sp = None if t is None else _innermost(spans, starts, t)
        name = sp[2] if sp else ""
        out.device_s[name] = out.device_s.get(name, 0.0) + (e0 - s0) / 1e6
        if sp and sp[0] in label:
            k = label[sp[0]]
            out.sweep_s[k] = out.sweep_s.get(k, 0.0) + (e0 - s0) / 1e6


def _innermost(spans, starts, t: float):
    """The innermost of the nested ``spans`` (``(start, end, name)``,
    sorted) open at ``t``: walking back from the last begun by ``t``, the
    first still open; None if none is."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][1] >= t:
            return spans[i]
        i -= 1
    return None
