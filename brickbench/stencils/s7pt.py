"""The 7-point star with one coefficient per direction, frozen.

A copy of what the port's stencil ``s7pt`` computes with the
coefficients of ``bench_params()``: ``coeff[c] = 0.03 * (c + 1)``
(``bricklib_tpu_torch/stencils/common.py``: ``bench_params`` and
``directional_star``; upstream ``stencils/7pt.py`` and the fill of
``stencils/fake.h``).  The port orders the directions centre, +i, -i,
+j, -j, +k, -k, with i the innermost array axis.
"""

TAPS = [
    ((0, 0, 0), 0.03),
    ((0, 0, 1), 0.06),
    ((0, 0, -1), 0.09),
    ((0, 1, 0), 0.12),
    ((0, -1, 0), 0.15),
    ((1, 0, 0), 0.18),
    ((-1, 0, 0), 0.21),
]
