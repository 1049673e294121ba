"""Conditional 7pt: per-tap max(·, 0) then |·| via If
(ref: stencils/cond.py).

Original: ``bricklib_tpu/stencils/cond.py``.
"""

from ..st import ConstRef, Func, Grid, Index, If
from .common import coeff_refs, indices

input = Grid("bIn", 3)
output = Grid("bOut", 3)
coeff = coeff_refs("coeff", 7)
maxfunc = Func("max", 2)
zero = ConstRef("0.0")

idx = indices(3)
calc = coeff[0] * maxfunc(input(*idx), zero)
c = 1
for d in range(3):
    for s in (1, -1):
        args = list(idx)
        args[d] = idx[d] + s
        calc = calc + coeff[c] * maxfunc(input(*args), zero)
        c += 1
calc = If(calc > 0, calc, -calc)

i, j, k = Index(0), Index(1), Index(2)
output(i, j, k).assign(calc)

STENCIL = [output]
