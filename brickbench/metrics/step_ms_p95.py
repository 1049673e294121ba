"""The 95th percentile of the window's step times: a step is the interval
between CUDA events recorded at its start and end on each card, the
longest over the cards."""

import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(rec):
    if len(rec.step_s) < 20:
        return None
    return statistics.quantiles(rec.step_s, n=20)[-1] * 1e3
