"""Device milliseconds a step and card of K8 on its compiled 125-point
layout: the operations launched inside the program's ``bricklib.sweep``
spans (``brickbench.program_trace``'s window), counted only where every
sweep span begun in the window was one launch of K8 that ran the
compiled ``LayoutMxu125`` body (the program's counter ``k8_layout``
moved once a span).  None where no device operation was traced (the
CPU), where the program has no such counter, or where other sweeps or
K8's generic body ran."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None or not p.devices or not p.steps:
        return None
    n = p.spans.get(program_trace.SWEEP, 0)
    if not n or p.counters.get("k8_layout") != n:
        return None
    return p.device_s.get(program_trace.SWEEP, 0.0) / p.steps / len(
        p.devices) * 1e3
