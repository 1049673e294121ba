"""Megabytes of ghost bricks the exchanges write a step and card (each
byte of the payload once): the change of the program's ``exchange_bytes``
counter over ``brickbench.program_trace``'s window, over 1e6.  Counted on
the CPU as on the cards; None where the program has no counters."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "MB", "lower", "program_counter"
LAYER, MOVES = "comm.exchange", "gstencil_per_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None or not p.steps:
        return None
    return p.counters["exchange_bytes"] / p.steps / p.cards / 1e6
