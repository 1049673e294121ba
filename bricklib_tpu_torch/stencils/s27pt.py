"""27-point box, coeff[0..26] in lexicographic (k, j, i) tap order
(ref: stencils/3axis.cpp d3pt27 — without the reference kernel's
index typos at taps 15/16/18, which its array/brick twins share).

Original: ``bricklib_tpu/stencils/s27pt.py``.
"""

from ..st import ConstRef, Grid, Index
from .common import box, box_offsets

input = Grid("bIn", 3)
output = Grid("bOut", 3)

_order = {offs: n for n, offs in enumerate(box_offsets(3, 1))}
calc = box(input, 1, lambda offs: ConstRef(f"coeff[{_order[offs]}]"))

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
