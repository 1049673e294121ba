"""What bounds kernel K8: its body timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k8_probe [--tree DIR] [--reps 2]

Builds, into ``build/k8_probe/<tree name>/``, the K8 source of a checkout
(``--tree``, default this one) in several forms, each alone as a shared
library with K8's C entry point, and times each form through that tree's
own wrapper (``pencil_sweep_mxu``, in a process that imports the tree's
package, CUDA events, 10 launches after one) on the 125-point leg's sweep:
512^3 ``mpi125pt``, bricks (8, 8, 512), the periodic table, fuse 1.

- ``full``: the body as K8 runs it;
- ``no-loads``: level 0 never loaded (shared memory keeps stale values, so
  the results are wrong; the arithmetic and the barriers stay);
- ``no-vi``: the first design (whole-slab blocks) without its V and i stages
  (the slab load and the W stage stay);
- ``no-compute``: the streaming design without its compiled layout's W,
  V and i stages (the loads, the barriers and the row offsets stay);
- ``generic``: the streaming design with the generic body forced (no
  compiled layout; its shared memory counted in the entry point).

A form whose anchors the tree's source lacks is left out.  Forms other
than ``full`` and ``generic`` give wrong results; the differences name
what each part costs.  The last line is one JSON object, with the card's
name and power limit.  Only a measurement: no path of the port runs these
forms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "k8_probe"
SOURCE = "pencil_sweep_mxu.cu"
HEADER = "mxu_stream.cuh"
ENTRY = "bt_pencil_sweep_mxu"

# per form, (file, anchor, replacement) edits; a form applies when every
# anchor is in its file
FORMS = {
    "full": [],
    "no-loads": [
        # the first design: the slab's one copy per element
        (SOURCE, "bt_copy_async(S + e, x + rowoff[row] + i);", ";"),
        # the streaming design: a plane's pieces
        (HEADER, "    auto issue = [&](int q) {",
         "    auto issue = [&](int q) {\n"
         "        if (true) { bt_cp_commit(); return; }")],
    "no-vi": [
        (SOURCE, "for (int e = threadIdx.x; e < nout; e += blockDim.x) {",
         "for (int e = threadIdx.x; e < 0; e += blockDim.x) {")],
    "no-compute": [
        (HEADER, "            if (pC >= P0 && pC < P1 && warp_live) {\n"
                 "                constexpr int NK",
         "            if (false) {\n                constexpr int NK")],
    "generic": [
        (SOURCE, "    const bool layout = mxu_layout_matches",
         "    const bool layout = false && mxu_layout_matches"),
        (SOURCE, "        || mxu_smem_bytes(g, layout ? 0 : nW) > smem_bytes)",
         "        || (smem_bytes = (int)mxu_smem_bytes(g, nW)) > 232448)")],
}


def form_sources(tree: Path, edits: list, files=(SOURCE, HEADER)) -> dict | None:
    """``{file name: text}`` of ``tree``'s kernel source and stream header
    (``files``, where the tree has them) with one form's ``edits``
    applied, or None when the form has edits and none of their anchors is
    in the tree's files."""
    csrc = tree / "bricklib_tpu_torch" / "csrc"
    texts = {f: (csrc / f).read_text() for f in files
             if (csrc / f).exists()}
    applied = [e for e in edits if e[0] in texts and e[1] in texts[e[0]]]
    if edits and not applied:
        return None
    for f, anchor, repl in applied:
        texts[f] = texts[f].replace(anchor, repl)
    return texts


def build_forms(tree: Path, source: str, forms: dict, out: Path) -> dict:
    """Each form of ``tree``'s ``source`` (``forms``: name -> ``{file:
    text}``) compiled alone into ``out/<form>/lib.so``, one nvcc each,
    all started together; ``{form: library path}``."""
    from bricklib_tpu_torch import _build

    csrc = tree / "bricklib_tpu_torch" / "csrc"
    procs = {}
    for name, texts in forms.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             f"-I{d}", f"-I{csrc}", "-o", str(d / "lib.so"), str(d / source)],
            stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc {name}: {p.stderr.read()}")
    return {name: out / name / "lib.so" for name in procs}


class Swapped:
    """The kernel library with one entry point taken from another
    library (a probe form's), for the wrappers of the tree under test."""

    def __init__(self, lib, form: Path, entry: str, argtypes):
        self._lib = lib
        fn = getattr(ctypes.CDLL(str(form)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        self._entry, self._fn = entry, fn

    def __getattr__(self, name):
        return self._fn if name == self._entry else getattr(self._lib, name)


def time_forms(libs: dict, entry: str, run, reps: int) -> dict:
    """In this process (the tree's package imported): ms per launch of
    ``run()`` with each form's library swapped in, ``reps`` rounds."""
    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k1_regimes import cuda_ms

    full = _build.library()
    ms: dict = {}
    try:
        for _ in range(reps):
            for name, path in libs.items():
                _build._lib = Swapped(full, path, entry,
                                      _build.SIGNATURES[entry])
                ms.setdefault(name, []).append(cuda_ms(run, 10))
    finally:
        _build._lib = full
    return ms


def sass_runs(lib: Path, pick, top: int = 4) -> dict:
    """The kernel of ``lib`` that ``pick`` chooses from the texts of its
    functions (``cuobjdump -sass``): its name and its runs of
    instructions between branches that hold FFMAs, by opcode, the ``top``
    largest."""
    from bricklib_tpu_torch import _build

    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    kernel = pick(sass.split("Function : ")[1:])
    ops = [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
        kernel)]
    runs, cur = [], Counter()
    for op in ops:
        cur[op] += 1
        if op in ("BRA", "EXIT", "BAR"):
            if cur["FFMA"]:
                runs.append(dict(cur.most_common()))
            cur = Counter()
    runs.sort(key=lambda r: -sum(r.values()))
    return {"kernel": kernel.split("\n", 1)[0].strip(), "runs": runs[:top]}


def sweep_125():
    """The 125-point leg's sweep: (fn, storage shape)."""
    from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=(512,) * 3, ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 512)).initialize(
        skinlist_by_name("good", 3))
    fn = pencil_sweep_mxu("mpi125pt", dec.periodic_grid((0, 1, 2)),
                          dec.bdims, dec.nbricks, bench_params())
    return fn, (dec.nbricks, 8, 8 * 512)


def worker(tree: Path, reps: int) -> dict:
    from bricklib_tpu_torch.bench.k1_regimes import storage

    forms = {n: t for n, e in FORMS.items()
             if (t := form_sources(tree, e)) is not None}
    libs = build_forms(tree, SOURCE, forms, OUT / tree.resolve().name)
    fn, shape = sweep_125()
    x = storage(shape, 3)
    return time_forms(libs, ENTRY, lambda: fn(x), reps)


def run_worker(script: str, tree: Path, reps: int) -> dict:
    """``script --worker`` in a process importing ``tree``'s package."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(
        [sys.executable, script, "--worker", "--tree", str(tree),
         "--reps", str(reps)], cwd=tree, env=env, capture_output=True,
        text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"worker in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(script: str = __file__, kernel: str = "K8", work=worker,
         doc: str = __doc__) -> None:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(work(a.tree.resolve(), a.reps)))
        return
    import torch

    from bricklib_tpu_torch.bench.k1_regimes import card

    if not torch.cuda.is_available():
        sys.exit(f"{kernel.lower()}_probe: needs a CUDA card")
    res = {"card": card(), "tree": str(a.tree)}
    print(res["card"], flush=True)
    res["ms"] = run_worker(str(Path(script).resolve()), a.tree.resolve(),
                           a.reps)
    for name, ms in res["ms"].items():
        if name == "sass":
            print(f"[{kernel} probe sass] kernel {ms['kernel']}", flush=True)
            for run in ms["runs"]:
                print(f"[{kernel} probe sass] run of {sum(run.values())} "
                      f"instructions: {run}", flush=True)
            continue
        print(f"[{kernel} probe {name}] " + ", ".join(f"{v:.3f}" for v in ms)
              + " ms", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
