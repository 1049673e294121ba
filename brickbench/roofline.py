"""The least time one card could take for a cell's step, counted from the
cell's shapes.

``bound`` and the peaks are a frozen copy of
``bricklib_tpu_torch/bench/roofline.py`` (``PEAK_BYTES``, ``PEAK_F32``,
``bound``): NVIDIA's published H100 SXM figures at 700 W, 3.35 TB/s of
device memory and 67 TFLOP/s of float32 outside the tensor cores.

:func:`step_work` counts a step's compulsory work from the shapes alone,
never from a kernel's plan, so it reads the same whatever fused depth or
kernel implements the step: one read of every brick of a rank's storage
(owned and ghost: the domain grown by the ghost depth on each side) and
one write of its owned bricks, 4 bytes an element; two operations (a
multiply and an add) per tap, owned element and iteration.
"""

from __future__ import annotations

import math

PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, what bounds it): the least time the card could take to
    move ``nbytes`` through device memory and do ``flops`` float32
    operations."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def step_work(domain, ghost, ntaps: int, st_iter: int,
              itemsize: int = 4) -> tuple[int, int]:
    """(bytes, operations) of one rank's step: ``domain`` owned elements
    a rank per axis, ``ghost`` elements of ghost on each side per axis,
    ``ntaps`` taps, ``st_iter`` iterations."""
    owned = math.prod(int(d) for d in domain)
    stored = math.prod(int(d) + 2 * int(g) for d, g in zip(domain, ghost))
    return itemsize * (stored + owned), 2 * ntaps * owned * st_iter
