"""Host seconds of the program's ``build_step``: the decomposition, its
tables and the host-side initial state."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER, MOVES = "drivers", "setup_s"


def read(rec):
    return rec.plan_s
