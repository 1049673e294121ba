"""α/β symmetric 7-point star (ref: stencils/mpi7pt.py).

Original: ``bricklib_tpu/stencils/mpi7pt.py``.
"""

from ..st import ConstRef, Grid, Index
from .common import star

input = Grid("in", 3)
output = Grid("out", 3)

calc = star(input, 1, [ConstRef("MPI_ALPHA"), ConstRef("MPI_BETA")])

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
