"""The share of the profiler's window in which no kernel, copy or fill
ran on any card."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "gstencil_per_s"


def read(rec):
    t = rec.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return (1 - t.busy_s() / t.window_s) * 100
