"""7-point star, per-direction coefficients coeff[0..6]
(ref: stencils/7pt.py).

Original: ``bricklib_tpu/stencils/s7pt.py``.
"""

from ..st import Grid, Index
from .common import coeff_refs, directional_star

input = Grid("bIn", 3)
output = Grid("bOut", 3)
coeff = coeff_refs("coeff", 7)

calc = directional_star(input, coeff)
i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
