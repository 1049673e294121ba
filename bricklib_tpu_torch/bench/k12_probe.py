"""What bounds kernel K12: its body timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k12_probe [--tree DIR] [--reps 2]
                                                 [--sass]

Builds, into ``build/k12_probe/<tree name>/``, the K12 source of a
checkout (``--tree``, default this one) in several forms, each alone as a
shared library with K12's C entry point, and times each form through that
tree's own wrapper (``pencil_sweep_nd``, in a process that imports the
tree's package, CUDA events, 10 launches after one) on the path's sweep:
the 5-D 11-point star at (8, 8, 64, 64, 512), bricks (2, 2, 8, 8, 512),
over the owned bricks.

- ``full``: the body as K12 runs it;
- ``no-table``: the first design (one thread per output) without its
  table loads (each tap reads the brick the table cell's id names, not the
  table's entry);
- ``one-tap``: the first design with only the first tap of each output
  (decode, table, store);
- ``no-loads``: the streaming design with level 0 never loaded (shared
  memory keeps stale values; the arithmetic and the barriers stay);
- ``no-compute``: the streaming design without its output items (the
  loads, the barriers and the row offsets stay);
- ``generic``: the streaming design with the compiled star's body turned
  off (the generic body).

A form whose anchors the tree's source lacks is left out.  Forms other
than ``full`` and ``generic`` give wrong results; the differences name
what each part costs.  ``--sass`` also counts, with ``cuobjdump``, the
instructions of the ``full`` form's 5-D kernel between branches, by opcode
(the runs holding FFMAs, largest first: the first design's tap loop, the
streaming design's item loop).  The last line is one JSON object, with the
card's name and power limit.  Only a measurement: no path of the port runs
these forms.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# by path: a worker imports the package of the tree under test, which
# may not hold this directory's helpers
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k8_probe  # noqa: E402
import k12_regimes  # noqa: E402

OUT = k8_probe.ROOT / "build" / "k12_probe"
SOURCE = "pencil_sweep_nd.cu"
HEADER = "pencil_stream_nd.cuh"
ENTRY = "bt_pencil_sweep_nd"

FORMS = {
    "full": [],
    "no-table": [
        (SOURCE, "const long long id = __ldg(table + to);",
         "const long long id = to;")],
    "one-tap": [
        (SOURCE, "    for (int t = 0; t < g.ntaps; ++t) {\n"
                 "        const int* tp = s_taps + t * row;",
         "    for (int t = 0; t < 1; ++t) {\n"
         "        const int* tp = s_taps + t * row;")],
    "no-loads": [
        (HEADER, "        if (pc.n <= BTN_PIECES) {",
         "        if (true) return;\n        if (pc.n <= BTN_PIECES) {")],
    "no-compute": [
        (HEADER, "        for (int i = warp; i < nitm; i += nwarp) {",
         "        for (int i = warp; i < 0; i += nwarp) {")],
    "generic": [
        (SOURCE, "    if (layout && nd == 5 && star11_matches(",
         "    if (false && layout && nd == 5 && star11_matches(")],
}


def five_d(funcs: list) -> str:
    """The 5-D kernel among ``funcs`` (the compiled star's where there is
    one)."""
    five = [f for f in funcs if "ILi5E" in f.split("\n", 1)[0]]
    return next((f for f in five if "LayoutStar11" in f.split("\n", 1)[0]),
                five[0])


def path_sweep():
    """The path's sweep: (fn, storage shape)."""
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import pencil_sweep_nd
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    bd = k12_regimes.BD5
    dec = BrickDecomp(dims=k12_regimes.DIMS5, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", 5))
    fn = pencil_sweep_nd(k12_regimes.star_nd(5), dec.grid, bd, dec.nbricks,
                         {})
    return fn, (dec.nbricks,) + bd


def worker(tree: Path, reps: int) -> dict:
    from bricklib_tpu_torch.bench.k1_regimes import storage

    files = (SOURCE, HEADER)
    forms = {n: t for n, e in FORMS.items()
             if (t := k8_probe.form_sources(tree, e, files)) is not None}
    libs = k8_probe.build_forms(tree, SOURCE, forms,
                                OUT / tree.resolve().name)
    fn, shape = path_sweep()
    x = storage(shape, 3)
    res = k8_probe.time_forms(libs, ENTRY, lambda: fn(x), reps)
    if os.environ.get("K12_PROBE_SASS") == "1":
        res["sass"] = k8_probe.sass_runs(libs["full"], five_d)
    return res


if __name__ == "__main__":
    # --sass reaches the worker process through its environment
    if "--sass" in sys.argv:
        sys.argv.remove("--sass")
        os.environ["K12_PROBE_SASS"] = "1"
    k8_probe.main(__file__, "K12", worker, __doc__)
