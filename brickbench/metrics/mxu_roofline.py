"""The K8 sweeps' share of the step's compulsory bound, over
``mxu_sweep_ms``.  The bound is the least time one card could take for
its step, counted from the cell's shapes and its frozen taps alone: the
bytes of ``brickbench.roofline.step_work`` (one read of the storage, one
write of the owned bricks) and two operations (a multiply and an add) per
*distinct coefficient* of the taps, owned element and iteration, against
3.35 TB/s and 67 TFLOP/s.  No form that computes the stencil can do
fewer operations than one multiply and one add per distinct coefficient,
so the share stays under 100% whatever body runs the sweeps.  None where
``mxu_sweep_ms`` is."""

from brickbench import roofline
from brickbench.cell import metric_reader

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def bound_s(cell) -> float:
    """One card's least step time: the bytes of one subdomain's step and
    two operations per distinct coefficient, times the subdomains a card
    holds."""
    ncoeff = len({c for _off, c in cell.taps})
    nbytes, flops = roofline.step_work(cell.subdomain, cell.ghost, ncoeff,
                                       int(cell.config["st_iter"]))
    per_card = cell.ranks * cell.subdomains_per_rank / max(cell.chips, 1)
    return roofline.bound(nbytes * per_card, flops * per_card)[0]


def read(rec):
    sweep = metric_reader("mxu_sweep_ms").read(rec)
    if not sweep:
        return None
    return bound_s(rec.cell) * 1e3 / sweep * 100
