"""Kernel launches (the program's counters K1 to K12) plus its copies
between ranks (``rank_copies``) a step and card: their changes over
``brickbench.program_trace``'s window.  None on the CPU, where the
kernels' plain versions run and launch nothing, or where the program has
no counters."""

from brickbench import program_trace

UNIT, BETTER, SOURCE = "1", "lower", "program_counter"
LAYER, MOVES = "drivers", "gstencil_per_s"


def read(rec):
    p = program_trace.of(rec)
    if p is None or not p.cuda or not p.steps:
        return None
    n = sum(v for k, v in p.counters.items()
            if k == "rank_copies" or k[:1] == "K")
    return n / p.steps / p.cards
