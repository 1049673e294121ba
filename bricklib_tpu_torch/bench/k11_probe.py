"""What bounds kernel K11: its launch timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k11_probe [--tree DIR] [--reps 2]

Builds, into ``build/k11_probe/<tree name>/``, the K11 source of a
checkout (``--tree``, default this one) in five forms, each alone as a
shared library with K11's C entry point, and times each form through that
tree's own wrapper (``pencil_sweep_fusedx``, in a process that imports the
tree's package, CUDA events, 10 launches after one) at the full weak mesh
plan: four ranks of 512^3 on one card, mesh (2, 2, 1), bricks (8, 8, 512),
``s7pt``, 1,040 copy chunks.

- ``full``: the launch as K11 runs it;
- ``no-copies``: a chunk drawn is not copied (its arrival still counts,
  so the gates open; the ghosts keep stale values);
- ``no-gates``: the blocks sweep without waiting for the copies (a race:
  the ghosts they read may be stale);
- ``sweep-only``: both: the chunks are only counted and the blocks sweep
  at once;
- ``no-sweep``: the blocks return once their gates open;

and, for comparison, K1 alone on the same storage (the ghost-inclusive
sweep of the four ranks, K11's sweep blocks launched by K1).

Every form keeps the draws and the arrival counts of the full launch
(the counters carry over from one launch to the next), so the forms can
run one after another on one wrapper.  The differences name what the
copies, the gates and the sweep cost inside one launch.  The last line is one JSON object, with the card's name and power
limit.  Only a measurement: no path of the port runs these forms.
"""

from __future__ import annotations

import sys
from pathlib import Path

# by path: a worker imports the package of the tree under test, which
# may not hold this directory's helpers
sys.path.insert(0, str(Path(__file__).resolve().parent))
import k8_probe  # noqa: E402
import k11_regimes  # noqa: E402

SOURCE = "fused_exchange.cu"
ENTRY = "bt_fused_exchange"

# the copy call of the per-row design (PR 10) and of the streaming one
NO_COPY = [(SOURCE, "        copy_part(", "        if (false) copy_part("),
           (SOURCE, "        copy_chunk(", "        if (false) copy_chunk(")]
NO_GATE = [(SOURCE, "    if (gates) {\n        if (threadIdx.x == 0) {",
            "    if (false) {\n        if (threadIdx.x == 0) {")]
FORMS = {
    "full": [],
    "no-copies": NO_COPY,
    "no-gates": NO_GATE,
    "sweep-only": NO_COPY + NO_GATE,
    "no-sweep": [
        (SOURCE, "    sweep_block<NT, true>(",
         "    if (false) sweep_block<NT, true>("),
        (SOURCE, "    stream_block<L, true>(",
         "    if (false) stream_block<L, true>(")],
}


def worker(tree: Path, reps: int) -> dict:
    forms = {n: t for n, e in FORMS.items()
             if (t := k8_probe.form_sources(tree, e, (SOURCE,))) is not None}
    libs = k8_probe.build_forms(tree, SOURCE, forms,
                                k8_probe.ROOT / "build" / "k11_probe"
                                / tree.resolve().name)
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    fn, _put, k1, state, _dec = k11_regimes.case(k11_regimes.N, "s7pt")
    ms = k8_probe.time_forms(libs, ENTRY, lambda: fn(state), reps)
    flat = state[0].view((-1,) + k11_regimes.BD)
    ms["K1 alone"] = [cuda_ms(lambda: k1(flat), 10) for _ in range(reps)]
    return ms


if __name__ == "__main__":
    k8_probe.main(__file__, "K11", worker, __doc__)
