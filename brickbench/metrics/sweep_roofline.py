"""The sweeps' share of the step's compulsory bound: the least time one
card could take for its ranks' step, counted from the cell's shapes
(``brickbench.roofline.step_work``: one read of the storage, one write
of the owned bricks, two operations per tap, element and iteration,
against 3.35 TB/s and 67 TFLOP/s), over ``sweep_ms``."""

from brickbench.cell import metric_reader

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "codegen sweeps", "gstencil_per_s"


def read(rec):
    sweep = metric_reader("sweep_ms").read(rec)
    if not sweep:
        return None
    return rec.bound_s * 1e3 / sweep * 100
