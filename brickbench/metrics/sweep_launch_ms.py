"""Device milliseconds a sweep: the operations launched inside the
program's ``bricklib.sweep`` spans, over the number of such spans begun in
``brickbench.program_trace``'s window (one a launch of a sweep kernel on a
card).  None where no device operation was traced (the CPU), no sweep span
was, or the program has no spans."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None or not p.devices or not p.spans.get(program_trace.SWEEP):
        return None
    return p.device_s.get(program_trace.SWEEP, 0.0) / p.spans[
        program_trace.SWEEP] * 1e3
