"""125-point dense 5³ cube; 10 constants C0..C9 by symmetry class of the
sorted |offset| signature (ref: stencils/mpi125pt.py).

Original: ``bricklib_tpu/stencils/mpi125pt.py``.
"""

from ..st import ConstRef, Grid, Index
from .common import box, box_symmetry_class

input = Grid("in", 3)
output = Grid("out", 3)

calc = box(input, 2,
           lambda offs: ConstRef(f"MPI_C{box_symmetry_class(offs)}"))

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
