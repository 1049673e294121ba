"""The check that decides ``correct``: the plain reference against the
harness's own run of the program's step through the kernels' plain
versions (on the CPU), the control, and the faults it must catch."""

from __future__ import annotations

import pytest
import torch

from brickbench import calibrate, faults, fields, reference
from brickbench.harness import run_cell

from . import tiny

SEED = 2 ** 31 + 977  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("bench")
    tiny.write(r)
    return r


def _quiet(msg):
    pass


@pytest.mark.parametrize("name", ["t3", "t3f1", "t4", "tm"])
def test_program_matches_reference(root, name):
    cell = tiny.cell(root, name)
    rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu", log=_quiet)
    assert chk["ok"], chk
    assert chk["answers"] == min(2, rec.answers) >= 1
    assert chk["rel_err"][0] < 1e-5


def test_reference_sees_direction(root):
    """Swapping the +i and -i coefficients of the reference fails."""
    cell = tiny.cell(root, "t3")
    f = fields.draw_field(cell.global_domain, SEED, 0, "cpu")
    taps = cell.taps
    swapped = [taps[0], (taps[1][0], taps[2][1]), (taps[2][0], taps[1][1])] \
        + taps[3:]
    a = reference.iterate(f, taps, 6)
    b = reference.iterate(f, swapped, 6)
    assert reference.rel_err(b, a) > 1e-2


@pytest.mark.parametrize("name", ["t3", "t4", "tm"])
def test_control_fails(root, name):
    """The reference in bfloat16, in the program's place, reads far
    above the limit."""
    cell = tiny.cell(root, name)
    err = calibrate.control_reading(cell, SEED, "cpu")
    assert err > 10 * float(cell.traffic["limit_rel_err"])


@pytest.mark.parametrize("name", ["t3", "tm"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_exchange"])
def test_fault_is_caught(root, name, fault):
    """With the timed path broken underneath, ``correct`` is false."""
    cell = tiny.cell(root, name)
    if fault == "no_exchange":
        with faults.no_exchange():
            _rec, chk = run_cell(cell, SEED, 0.5, False, device="cpu",
                                 log=_quiet)
    else:
        _rec, chk = run_cell(cell, SEED, 0.5, False, device="cpu",
                             wrap=faults.WRAPS[fault], log=_quiet)
    assert not chk["ok"], chk


def test_rel_err_not_finite():
    want = torch.ones(4, 4)
    got = want.clone()
    got[1, 1] = float("nan")
    assert reference.rel_err(got, want) == float("inf")
    assert reference.rel_err(want, want) == 0.0


def test_fields_follow_the_seed():
    a = fields.draw_field((4, 8, 8), SEED, 1, "cpu")
    assert torch.equal(a, fields.draw_field((4, 8, 8), SEED, 1, "cpu"))
    assert not torch.equal(a, fields.draw_field((4, 8, 8), SEED, 0, "cpu"))
    assert not torch.equal(a, fields.draw_field((4, 8, 8), SEED + 1, 1,
                                                "cpu"))
    assert float(a.min()) >= -1 and float(a.max()) < 1


def test_storage_round_trip():
    import numpy as np

    grid = np.arange(16).reshape(4, 4, 1)[::-1].copy()
    rows = fields.owned_rows(grid, (1, 1, 0), 16)
    block = torch.arange(2 * 2 * 8 * 8 * 16, dtype=torch.float32).reshape(
        16, 16, 16)
    st = fields.to_storage(block, torch.from_numpy(rows), (8, 8, 16), 16)
    back = fields.from_storage(st, torch.from_numpy(rows), (8, 8, 16),
                               (16, 16, 16))
    assert torch.equal(back, block)
    with pytest.raises(ValueError):
        fields.owned_rows(np.zeros((4, 4, 1), np.int64), (1, 1, 0), 16)
