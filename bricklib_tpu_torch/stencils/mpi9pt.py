"""4-D 9-point star with literal coefficients (ref: stencils/mpi9pt.py).

Original: ``bricklib_tpu/stencils/mpi9pt.py``.
"""

from ..st import Grid, Index
from .common import star

input = Grid("in", 4)
output = Grid("out", 4)

calc = star(input, 1, [0.2, 0.1])

i, j, k, l = Index(0), Index(1), Index(2), Index(3)
output(i, j, k, l).assign(calc)

STENCIL = [output]
