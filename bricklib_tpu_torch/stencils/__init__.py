"""The stencil corpus (ref: bricklib's ``stencils/*.py``).

Each module exports ``STENCIL = [output]`` exactly like the reference; the
tap patterns are built programmatically from the generators in
:mod:`.common` instead of hand-written term lists.

Corpus:
  s7pt     — 7-point star, per-direction coeff[0..6]   (ref: stencils/7pt.py)
  cond     — 7pt + max() + |x| via If                  (ref: stencils/cond.py)
  s27pt    — 27-point box, coeff[0..26]                (ref: stencils/3axis.cpp d3pt27)
  mpi7pt   — α/β symmetric star                        (ref: stencils/mpi7pt.py)
  mpi9pt   — 4-D 9-point star                          (ref: stencils/mpi9pt.py)
  mpi13pt  — radius-2 star, B0..B2                     (ref: stencils/mpi13pt.py)
  mpi25pt  — radius-4 star, A0..A4                     (ref: stencils/mpi25pt.py)
  mpi125pt — 5³ dense cube, 10 symmetry coeffs C0..C9  (ref: stencils/mpi125pt.py)

Original: ``bricklib_tpu/stencils/__init__.py``.
"""

from . import common
from .common import DEFAULT_PARAMS, bench_params, stencil_by_name, CORPUS

__all__ = ["common", "DEFAULT_PARAMS", "bench_params", "stencil_by_name",
           "CORPUS"]
