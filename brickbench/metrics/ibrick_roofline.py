"""The i-bricked sweeps' share of the step's compulsory bound: the least
time one card could take for its subdomains' step, counted from the
cell's shapes (``brickbench.roofline.step_work`` times the subdomains a
card holds), over ``ibrick_sweep_ms``.  It reads the same whatever body
of K1 runs the sweeps; None where ``ibrick_sweep_ms`` is."""

from brickbench.cell import metric_reader

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def read(rec):
    sweep = metric_reader("ibrick_sweep_ms").read(rec)
    if not sweep:
        return None
    return rec.bound_s * 1e3 / sweep * 100
