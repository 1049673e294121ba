"""Device milliseconds a step of everything but the exchange, per card:
the busy time of the operations launched inside the program's step calls,
less ``exchange_ms``; a sweep kernel is counted whatever its name."""

from brickbench.cell import metric_reader

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def read(rec):
    t = rec.trace
    ex = metric_reader("exchange_ms").read(rec)
    if ex is None:
        return None
    busy = t.busy_mean_s(owner="brickbench.step") / t.steps * 1e3
    return busy - ex if busy > ex else None
