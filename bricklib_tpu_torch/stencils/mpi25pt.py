"""Radius-4 star, coefficients A0..A4 by ring (ref: stencils/mpi25pt.py).

Original: ``bricklib_tpu/stencils/mpi25pt.py``.
"""

from ..st import ConstRef, Grid, Index
from .common import star

input = Grid("in", 3)
output = Grid("out", 3)

calc = star(input, 4, [ConstRef(f"MPI_A{r}") for r in range(5)])

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
