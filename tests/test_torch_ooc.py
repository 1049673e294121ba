"""The port's out-of-core sweep (``bricklib_tpu_torch.ooc``) on the CPU
against the reference ``ooc_sweep`` (CPU, the dense Pallas kernel in
interpret mode), on the same numpy input.

Results are compared at abs-or-rel 1e-5 (float32 sums in another order);
the slab count and the bytes each way must be the reference's, and the
input must come back untouched.  On the CPU the port runs kernel K7's
plain version on each slab; the streamed pass on the card is in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.ooc import ooc_sweep as ref_ooc_sweep
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil_kernel
from bricklib_tpu_torch.ooc import _slab_plan, ooc_sweep

PARAMS = bench_params()
SAME = ("slabs", "h2d_bytes", "d2h_bytes")


def _both(name, seed, shape=(16, 16, 256), **kw):
    g = random_array(shape, np.float32, seed)
    ref_stats, stats = {}, {}
    want = ref_ooc_sweep(g, stencil_by_name(name)[0], PARAMS,
                         stats=ref_stats, **kw)
    before = dense_stencil_kernel.launches
    got = ooc_sweep(g, port_stencils.stencil_by_name(name)[0], PARAMS,
                    stats=stats, device="cpu", **kw)
    assert dense_stencil_kernel.launches == before
    np.testing.assert_array_equal(g, random_array(shape, np.float32, seed))
    assert isinstance(got, np.ndarray) and got.shape == g.shape
    assert compare_arrays(got, np.asarray(want), 1e-5)
    for k in SAME:
        assert stats[k] == ref_stats[k], k
    return stats


# the cases of tests/test_ooc.py:24-28
@pytest.mark.parametrize("name,slab_rows,iters", [
    ("s7pt", 6, 2),       # 3 slabs, radius 1, two passes
    ("mpi13pt", 5, 1),    # radius 2: slab overlap deeper than 1
    ("s7pt", 16, 1),      # single slab degenerate case
])
def test_ooc_matches_the_reference(name, slab_rows, iters):
    stats = _both(name, 7, slab_rows=slab_rows, iters=iters)
    assert stats["slabs"] == -(-16 // slab_rows)


def test_ooc_slab_bytes_budget():
    """slab_bytes bounds the derived slab height (many small slabs)."""
    row = (16 + 16) * (256 + 2 * 63) * 4   # padded row bytes, roughly
    stats = _both("s7pt", 8, slab_bytes=8 * row)
    assert stats["slabs"] >= 4


def test_ooc_narrow_i_wraps_more_than_once():
    """An i extent of 16 gets an i pad of 56 (the padded row grows to 128
    lanes), so the pad wraps the row more than once."""
    stats = _both("s7pt", 9, shape=(12, 8, 16), slab_rows=5, iters=2)
    assert stats["slabs"] == 3


def test_slab_plan_covers_the_domain():
    assert _slab_plan(1024, 147) == [(s, min(s + 147, 1024))
                                     for s in range(0, 1024, 147)]
    assert len(_slab_plan(1024, 147)) == 7


def test_ooc_guards_and_default_device():
    g = np.zeros((16, 16, 256), np.float32)
    sd = port_stencils.stencil_by_name("s7pt")[0]
    with pytest.raises(ValueError, match="even"):
        ooc_sweep(np.zeros((16, 16, 255), np.float32), sd, PARAMS,
                  device="cpu")
    with pytest.raises(ValueError, match="sublane"):
        ooc_sweep(np.zeros((16, 12, 256), np.float32), sd, PARAMS,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="3-D"):
        ooc_sweep(g, "mpi9pt", PARAMS, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ooc_sweep(g, sd, PARAMS)
