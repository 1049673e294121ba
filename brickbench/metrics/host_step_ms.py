"""Host milliseconds of one call of the program's step, which enqueues
its work and returns: the mean over runs of steps each started on idle
cards, outside the profiler's window."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "drivers", "gstencil_per_s"


def read(rec):
    if not rec.host_step_s:
        return None
    return sum(rec.host_step_s) / len(rec.host_step_s) * 1e3
