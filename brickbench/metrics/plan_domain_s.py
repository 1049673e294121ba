"""Host seconds of the program's ``bricklib.plan.domain`` span: the
``build_step`` draw of the global domain, bricked per rank, and the state
put on the cards (``brickbench.program_trace``'s build).  None where the
program has no such span."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER, MOVES = "drivers", "setup_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None:
        return None
    return p.plan_s.get("bricklib.plan.domain")
