"""Kernel K7's launch plan (``codegen/dense_kernel.py``,
``DensePlan.stream``) on the CPU: the k-streaming blocks of
``csrc/dense_stencil.cu`` decoded as the kernel decodes them.

At the out-of-core pass's slabs (the first, 149 x 1040 x 1152 padded, and
the last, shorter one of a 1024^3 pass) and at the small shapes
``chip_smoke.py`` checks, the blocks write every cell of the padded array
exactly once: the interior rows computed over the whole padded i width
(the pad i columns included), the k and j pad rows as zeros.  The shared
memory of a block stays within the budget and equals the kernel's count;
s7pt and mpi7pt take the compiled star, whose offsets and order
(``csrc/tap_layouts.cuh``) are those of their folded taps, and every
other tap list the generic body.  The kernel itself is held against its
plain version on the card in ``tests/test_torch_gpu.py``; the plain
version against the reference in ``tests/test_torch_dense_stencil.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from bricklib_tpu_torch import st
from bricklib_tpu_torch.codegen import dense_kernel
from bricklib_tpu_torch.codegen.dense_kernel import (K7_LAYOUTS,
                                                     _dense_stream,
                                                     dense_smem,
                                                     dense_stencil)
from bricklib_tpu_torch.codegen.pencil_kernel import STREAM_SMEM_BUDGET
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

from torch_2d_stencils import two_inputs_3d

CSRC = Path(dense_kernel.__file__).resolve().parents[1] / "csrc"
OOC_PADS = (1, 8, 64)
SHAPES = [("s7pt", (149, 1040, 1152), OOC_PADS),     # the first slab
          ("s7pt", (144, 1040, 1152), OOC_PADS),     # the last slab
          ("mpi7pt", (149, 1040, 1152), OOC_PADS),
          ("mpi13pt", (24, 32, 128), (4, 8, 48)),
          ("s27pt", (10, 24, 128), (1, 8, 40)),
          ("s7pt", (11, 24, 256), (1, 8, 64)),
          ("mpi7pt", (3, 24, 128), (1, 8, 64)),
          ("two", (12, 24, 128), (2, 8, 48))]


def _fn(name, shape, pad):
    sd = two_inputs_3d(st) if name == "two" else stencil_by_name(name)[0]
    return dense_stencil(sd, shape, pad, bench_params())


def _coverage(sp):
    """Per (k, j, i tile) of the padded array: how often a block computes
    it and how often one writes it as a pad zero; the i tiles' spans."""
    SK, SJ, SI = sp.shape
    comp = np.zeros((SK, SJ, sp.nit), np.int32)
    zero = np.zeros((SK, SJ, sp.nit), np.int32)
    spans = set()
    for (kc, jc, ic), (kw, jw, iw) in sp.blocks():
        assert ic == iw
        spans.add(ic)
        t = ic[0] // sp.ti
        comp[kc[0]:kc[1], jc[0]:jc[1], t] += 1
        zero[kw[0]:kw[1], jw[0]:jw[1], t] += 1
        zero[kc[0]:kc[1], jc[0]:jc[1], t] -= 1
    return comp, zero, spans


@pytest.mark.parametrize("name,shape,pad", SHAPES)
def test_blocks_write_every_cell_once(name, shape, pad):
    sp = _fn(name, shape, pad).plan.stream()
    comp, zero, spans = _coverage(sp)
    SK, SJ, SI = shape
    pk, pj, _ = pad
    # the i tiles are the whole padded row, pad columns included
    assert sorted(spans) == [(t * sp.ti, (t + 1) * sp.ti)
                             for t in range(SI // sp.ti)]
    assert comp.min() >= 0 and zero.min() >= 0
    assert np.all(comp + zero == 1)
    inner = np.zeros((SK, SJ), bool)
    inner[pk:SK - pk, pj:SJ - pj] = True
    assert np.array_equal(comp.max(2) == 1, inner)
    assert np.array_equal(comp.min(2) == 1, inner)
    assert len(sp.blocks()) == sp.nblocks


@pytest.mark.parametrize("name,shape,pad", SHAPES)
def test_footprint_fits_and_is_counted(name, shape, pad):
    plan = _fn(name, shape, pad).plan
    sp = plan.stream()
    nf = len(plan.fields)
    assert sp.smem_bytes <= STREAM_SMEM_BUDGET
    (klo, jlo, ilo), (khi, jhi, ihi) = plan.lo, plan.hi
    rows, width = sp.tj + jlo + jhi, sp.ti + 2 * sp.h
    assert sp.smem_bytes == 4 * nf * (klo + khi + 1 + sp.d) * rows * width
    assert sp.smem_bytes == dense_smem(nf, plan.lo, plan.hi, sp.tj, sp.ti,
                                       sp.h, sp.d)
    assert sp.tj % 4 == 0 and sp.ti % 32 == 0 and shape[2] % sp.ti == 0
    assert sp.h % 4 == 0 and sp.h >= max(ilo, ihi)
    assert sp.d in (1, 2) and 1 <= sp.kch <= shape[0] - 2 * pad[0]


def test_the_slab_fills_the_card():
    """At the first slab the planner takes whole waves of 132 SMs."""
    sp = _fn(*SHAPES[0]).plan.stream()
    per_sm = min(233472 // (sp.smem_bytes + 1024), 2048 // 512)
    assert sp.nblocks % (132 * per_sm) == 0


def test_planner_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="fits"):
        _dense_stream.__wrapped__((149, 1040, 1152), OOC_PADS, (1, 1, 1),
                                  (1, 1, 1), 1, 7, 5.5, budget=1024)


def _compiled_layouts() -> dict:
    """The 3-D layouts of ``csrc/tap_layouts.cuh``: name -> offsets per
    tap."""
    text = (CSRC / "tap_layouts.cuh").read_text()
    out = {}
    for name, body in re.findall(r"struct (Layout\w+) \{(.*?)\n\};", text,
                                 re.S):
        arrs = {a: [int(v) for v in vals.replace("\n", " ").split(",")]
                for a, vals in re.findall(
                    r"int (dw|dk|dj|di)\(int t\) \{\s*constexpr int "
                    r"v\[N\] = \{([^}]*)\}", body)}
        if sorted(arrs) == ["di", "dj", "dk"]:
            out[name] = np.stack([arrs[a] for a in ("dk", "dj", "di")], 1)
    return out


@pytest.mark.parametrize("name", ["s7pt", "mpi7pt"])
def test_star_is_compiled_in_the_folded_order(name):
    plan = _fn(name, (11, 24, 256), (1, 8, 64)).plan
    assert plan.layout() == "s7pt"
    offs = np.asarray([k[1:] for k, _c in plan.taps])
    assert all(k[0] == 0 for k, _c in plan.taps)
    assert np.array_equal(_compiled_layouts()["LayoutStar7"], offs)


def test_the_kernel_compiles_the_planners_layouts():
    """The entry point launches a compiled body for exactly the layouts
    the planner names (the star), the generic body otherwise."""
    src = (CSRC / "dense_stencil.cu").read_text()
    assert re.findall(r"layout_matches_dense<(\w+)>", src) == [
        "LayoutStar7"]
    assert K7_LAYOUTS == ("s7pt",)


def _reversed_star():
    """s7pt's offsets with the k taps first: the same set of taps in
    another order."""
    g, o = st.Grid("bIn", 3), st.Grid("bOut", 3)
    i, j, k = st.Index(0), st.Index(1), st.Index(2)
    c = [0.1 * (n + 1) for n in range(7)]
    o(i, j, k).assign(c[6] * g(i, j, k - 1) + c[5] * g(i, j, k + 1)
                      + c[4] * g(i, j - 1, k) + c[3] * g(i, j + 1, k)
                      + c[2] * g(i - 1, j, k) + c[1] * g(i + 1, j, k)
                      + c[0] * g(i, j, k))
    return st.load_stencil_module({"STENCIL": [o]})[0]


@pytest.mark.parametrize("name", ["mpi13pt", "s27pt", "mpi125pt", "two",
                                  "reversed star"])
def test_other_tap_lists_take_the_generic_body(name):
    sd = (_reversed_star() if name == "reversed star"
          else two_inputs_3d(st) if name == "two"
          else stencil_by_name(name)[0])
    plan = dense_stencil(sd, (12, 24, 128), (2, 8, 48), bench_params()).plan
    assert plan.layout() is None
    if name == "reversed star":
        star = _compiled_layouts()["LayoutStar7"]
        offs = np.asarray([k[1:] for k, _c in plan.taps])
        assert sorted(map(tuple, offs)) == sorted(map(tuple, star))
        assert not np.array_equal(offs, star)
    # the generic body streams too: one load per tap and output
    assert plan.stream().nblocks >= 1
