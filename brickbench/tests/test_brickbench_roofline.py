"""The step's compulsory bound, counted from the cell's shapes."""

from __future__ import annotations

import pytest

from brickbench import roofline
from brickbench.cell import load_cell
from brickbench.harness import bound_s

from . import tiny


def test_s7pt_512_by_hand():
    """(64 + 2)^2 bricks of 8 x 8 x 512 read, 64^2 written, 4 bytes;
    7 taps x 2 operations x 512^3 x 8 iterations."""
    nbytes, flops = roofline.step_work((512,) * 3, (8, 8, 0), 7, 8)
    assert nbytes == (66 * 66 + 64 * 64) * 8 * 8 * 512 * 4
    assert round(nbytes / 1e9, 3) == 1.108
    assert flops == 2 * 7 * 512 ** 3 * 8
    t, what = roofline.bound(nbytes, flops)
    assert what == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_mpi9pt_4d_by_hand():
    """(6 x 10 x 18) bricks of 4 x 8 x 8 x 512 read, 4 x 8 x 16 written."""
    nbytes, flops = roofline.step_work((16, 64, 128, 512), (4, 8, 8, 0), 9,
                                       4)
    assert nbytes == (6 * 10 * 18 + 4 * 8 * 16) * 4 * 8 * 8 * 512 * 4
    assert round(nbytes / 1e6) == 835
    assert flops == 2 * 9 * 16 * 64 * 128 * 512 * 4
    assert roofline.bound(nbytes, flops)[1] == "bytes"


def test_bound_ignores_fuse(tmp_path):
    """One domain at fuse 1 and fuse 4 reads the same bound."""
    tiny.write(tmp_path)
    a, b = tiny.cell(tmp_path, "t3"), tiny.cell(tmp_path, "t3f1")
    assert a.traffic["fuse"] != b.traffic["fuse"]
    assert bound_s(a) == bound_s(b) > 0


def test_benchmark_cells_bounds():
    """The 512^3 cells' bound is 0.331 ms a card; the mesh cell's too."""
    for name in ("s7pt-512-f4",):
        assert bound_s(load_cell(name)) == pytest.approx(1.1078e9 / 3.35e12,
                                                         rel=1e-4)
