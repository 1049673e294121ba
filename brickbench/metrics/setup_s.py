"""Seconds from the process's start to the first timed step: imports,
the program's set-up, the fields, the kernels' build on a checkout's
first run, and the warm-up."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec.setup_s
