"""Radius-2 star, coefficients B0/B1/B2 by ring (ref: stencils/mpi13pt.py).

Original: ``bricklib_tpu/stencils/mpi13pt.py``.
"""

from ..st import ConstRef, Grid, Index
from .common import star

input = Grid("in", 3)
output = Grid("out", 3)

calc = star(input, 2, [ConstRef("MPI_B0"), ConstRef("MPI_B1"),
                       ConstRef("MPI_B2")])

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
