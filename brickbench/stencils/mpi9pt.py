"""The 4-D 9-point star, frozen.

A copy of the port's stencil ``mpi9pt``: ``star(input, 1, [0.2, 0.1])``,
centre 0.2 and 0.1 on each of the eight axis neighbours
(``bricklib_tpu_torch/stencils/mpi9pt.py``; upstream
``stencils/mpi9pt.py``).
"""

TAPS = [((0, 0, 0, 0), 0.2)] + [
    (tuple(s if a == ax else 0 for a in range(4)), 0.1)
    for ax in range(4) for s in (1, -1)]
