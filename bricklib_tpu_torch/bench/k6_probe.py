"""What bounds kernel K6: its body timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k6_probe [--tree DIR] [--reps 2]
                                                [--sass]

As ``bench/k8_probe.py`` does for K8: builds the K6 source of a checkout
(``--tree``, default this one) in several forms, each alone as a shared
library, and times each through that tree's wrapper (``pencil_sweep_2d``)
on the 2-D path's sweep: the 9-point box at 16384^2, bricks (32, 16384),
the periodic row table, fuse 4.

- ``full``: the body as K6 runs it;
- ``no-loads``: level 0 never loaded (wrong results; the levels stay);
- ``no-levels``: no intermediate level computed (wrong results): the
  first design computes level F alone from the level-0 slab, the
  streaming design skips levels 1 to F-1 of every step.

``--sass`` also counts, with ``cuobjdump``, the instructions of the
``full`` form's compiled box body by opcode, and those of its runs
between branches that hold at least 24 FFMAs (an item's groups).

The last line is one JSON object, with the card's name and power limit.
Only a measurement: no path of the port runs these forms.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# by path: a worker imports the package of the tree under test, which
# may not hold this directory's helpers
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k8_probe  # noqa: E402

SOURCE = "pencil_sweep_2d.cu"
HEADER = "row_stream.cuh"
ENTRY = "bt_pencil_sweep_2d"
FORMS = {
    "full": [],
    "no-loads": [
        (SOURCE, "bt_copy_async(dst + e, src + rowoff[s] + xg);", ";"),
        (HEADER, "    auto issue = [&](int k) {",
         "    auto issue = [&](int k) {\n"
         "        if (true) { bt_cp_commit(); return; }")],
    "no-levels": [
        (SOURCE, "for (int l = 1; l <= F; ++l) {",
         "for (int l = F; l <= F; ++l) {"),
        (HEADER, "            if (k < 0 || k >= ngroups(l)) continue;",
         "            if (k < 0 || k >= ngroups(l) || l < F) continue;")],
}


def sweep_box9():
    """The 2-D path's sweep: (fn, storage shape)."""
    import numpy as np

    from bricklib_tpu_torch import st
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d
    from bricklib_tpu_torch.core import init_grid

    tests = str(Path.cwd() / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_2d_stencils import BUILDERS

    grid, info = init_grid((16384 // 32 + 2, 1))
    t = np.asarray(grid)[:, 0].copy()
    t[0], t[-1] = t[-2], t[1]
    fn = pencil_sweep_2d(BUILDERS["box9"](st), t, (32, 16384), info.nbricks,
                         fuse=4)
    return fn, (info.nbricks, 32, 16384)


def sass_counts(binary: Path) -> dict:
    """Opcode counts of the compiled box body in ``binary``: the whole
    kernel, and each run between branches with at least 24 FFMAs."""
    import re
    import subprocess
    from collections import Counter

    from bricklib_tpu_torch import _build

    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(binary)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    kernel = next(f for f in sass.split("Function : ")
                  if "10LayoutBox9" in f.split("\n", 1)[0])
    ops = [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
        kernel)]
    runs, cur = [], Counter()
    for op in ops:
        cur[op] += 1
        if op in ("BRA", "EXIT", "BAR"):
            if cur["FFMA"] >= 24:
                runs.append(dict(cur.most_common()))
            cur = Counter()
    return {"kernel": dict(Counter(ops).most_common()), "runs": runs}


def worker(tree: Path, reps: int) -> dict:
    from bricklib_tpu_torch.bench.k1_regimes import storage

    forms = {n: t for n, e in FORMS.items()
             if (t := k8_probe.form_sources(tree, e, (SOURCE, HEADER)))
             is not None}
    libs = k8_probe.build_forms(tree, SOURCE, forms,
                                k8_probe.ROOT / "build" / "k6_probe"
                                / tree.resolve().name)
    fn, shape = sweep_box9()
    x = storage(shape, 3)
    out = k8_probe.time_forms(libs, ENTRY, lambda: fn(x), reps)
    if SASS:
        out["sass"] = sass_counts(libs["full"])
    return out


# --sass reaches the worker process through its environment
SASS = os.environ.get("K6_PROBE_SASS") == "1"


if __name__ == "__main__":
    if "--sass" in sys.argv:
        sys.argv.remove("--sass")
        os.environ["K6_PROBE_SASS"] = "1"
    k8_probe.main(__file__, "K6", worker, __doc__)
