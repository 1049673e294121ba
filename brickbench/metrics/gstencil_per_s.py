"""Element updates a second over the window: every rank's domain times
ST_ITER times the steps completed, over the window's host-clock seconds
(from a wait for every card before the first step to a wait after the
last)."""

UNIT, BETTER, SOURCE = "GStencil/s", "higher", "host_clock"


def read(rec):
    if rec.window_s <= 0 or rec.steps == 0:
        return None
    return rec.cell.updates_per_step * rec.steps / rec.window_s / 1e9
