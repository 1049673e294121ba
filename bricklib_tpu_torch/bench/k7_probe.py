"""What bounds kernel K7: its body timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k7_probe [--tree DIR] [--reps 2]
                                                [--sass]

Builds, into ``build/k7_probe/<tree name>/``, the K7 source of a checkout
(``--tree``, default this one) in several forms, each alone as a shared
library with K7's C entry point, and times each form through that tree's
own wrapper (``dense_stencil``, in a process that imports the tree's
package, CUDA events, 10 launches after one) on one slab of the
out-of-core pass: s7pt, 149 x 1040 x 1152 floats, pads (1, 8, 64).

- ``full``: the body as K7 runs it;
- ``no-loads``: the input never loaded (shared memory keeps stale values;
  the arithmetic, the stores and the barriers stay);
- ``no-copies``: the first design (one block per output tile) with each
  element's address still computed but stored to shared memory in place
  of its copy (the integer work of the load loop without its bytes);
- ``no-compute``: the outputs never computed nor stored (the loads and
  the barriers stay);
- ``one-tap``: the first design with only the first tap of each output;
- ``generic``: the streaming design with the compiled star turned off
  (its generic body).

A form whose anchors the tree's source lacks is left out.  Forms other
than ``full`` and ``generic`` give wrong results; the differences name
what each part costs.  ``--sass`` also counts, with ``cuobjdump``, the
instructions of the ``full`` form's kernel (the compiled star's where
there is one) between branches, by opcode: the runs holding FFMAs,
largest first.  The last line is one JSON object, with the card's name
and power limit.  Only a measurement: no path of the port runs these
forms.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# by path: a worker imports the package of the tree under test, which
# may not hold this directory's helpers
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k8_probe  # noqa: E402

OUT = k8_probe.ROOT / "build" / "k7_probe"
SOURCE = "dense_stencil.cu"
ENTRY = "bt_dense_stencil"
SLAB, PADS = (149, 1040, 1152), (1, 8, 64)

FORMS = {
    "full": [],
    "no-loads": [
        # the first design: the tile's load loop
        (SOURCE, "    for (int f = 0; f < g.nf; ++f) {\n"
                 "        const float* __restrict__ src = p.in[f];",
         "    for (int f = 0; f < 0; ++f) {\n"
         "        const float* __restrict__ src = p.in[f];"),
        # the streaming design: a plane's pieces
        (SOURCE, "    auto issue = [&](int q, int sl) {",
         "    auto issue = [&](int q, int sl) {\n"
         "        if (true) { bt_cp_commit(); return; }")],
    "no-copies": [
        (SOURCE, "bt_copy_async(dst + e, src + k * plane + (long long)j * "
                 "g.SI + i);",
         "dst[e] = (float)(k * plane + (long long)j * g.SI + i);")],
    "no-compute": [
        (SOURCE, "    for (int e = threadIdx.x; e < nout; e += blockDim.x) {",
         "    for (int e = threadIdx.x; e < 0; e += blockDim.x) {"),
        (SOURCE, "for (int itm = warp; itm < nitems; itm += nwarp) {",
         "for (int itm = warp; itm < 0; itm += nwarp) {")],
    "one-tap": [
        (SOURCE, "&& j < g.SJ - g.pj) {\n"
                 "            for (int q = 0; q < t.n; ++q) {",
         "&& j < g.SJ - g.pj) {\n"
                 "            for (int q = 0; q < 1; ++q) {")],
    "generic": [
        (SOURCE, "    if (layout_matches_dense<LayoutStar7>(",
         "    if (false && layout_matches_dense<LayoutStar7>(")],
}


def star_kernel(funcs: list) -> str:
    """K7's kernel among ``funcs``: the compiled star's where there is
    one."""
    dense = [f for f in funcs if "dense" in f.split("\n", 1)[0]]
    return next((f for f in dense if "LayoutStar7" in f.split("\n", 1)[0]),
                dense[0])


def slab_stencil():
    """The out-of-core slab's K7 call: (fn, input shape)."""
    from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil
    from bricklib_tpu_torch.stencils import bench_params

    return dense_stencil("s7pt", SLAB, PADS, bench_params()), SLAB


def worker(tree: Path, reps: int) -> dict:
    from bricklib_tpu_torch.bench.k1_regimes import storage

    forms = {n: t for n, e in FORMS.items()
             if (t := k8_probe.form_sources(tree, e, (SOURCE,))) is not None}
    libs = k8_probe.build_forms(tree, SOURCE, forms,
                                OUT / tree.resolve().name)
    fn, shape = slab_stencil()
    x = storage(shape, 3)
    res = k8_probe.time_forms(libs, ENTRY, lambda: fn(x), reps)
    if os.environ.get("K7_PROBE_SASS") == "1":
        res["sass"] = k8_probe.sass_runs(libs["full"], star_kernel)
    return res


if __name__ == "__main__":
    # --sass reaches the worker process through its environment
    if "--sass" in sys.argv:
        sys.argv.remove("--sass")
        os.environ["K7_PROBE_SASS"] = "1"
    k8_probe.main(__file__, "K7", worker, __doc__)
