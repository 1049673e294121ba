"""Device milliseconds a step and card of the strong exchange: every
operation launched inside the program's ``bricklib.exchange`` spans
(``brickbench.program_trace``'s window), whatever its name, so the face
rows' gathers count beside kernel K5's copies.  None where no device
operation was traced (the CPU) or the program has no spans."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "comm.exchange", "gstencil_per_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None or not p.devices or not p.steps:
        return None
    return p.device_s.get(program_trace.EXCHANGE, 0.0) / p.steps / len(
        p.devices) * 1e3
