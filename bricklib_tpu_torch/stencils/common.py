"""Generators for the stencil corpus + default coefficient values.

The reference writes every tap out by hand (e.g. 125 lines in
stencils/mpi125pt.py); here the same stencils come from three generators:

- ``star(grid, radius, coeffs)``      — axis taps, one coeff per |offset|
  ring (the mpi13pt/mpi25pt shape).
- ``directional_star(grid, coeffs)``  — one coeff per direction in the
  reference's 7pt.py order: center, +i, -i, +j, -j, +k, -k.
- ``box(grid, radius, coeff_fn)``     — dense (2r+1)^d cube;
  ``coeff_fn(offsets)`` yields the coefficient expression per tap.  The
  mpi125pt symmetry classes (10 constants by sorted |offset| signature,
  ref: stencils/mpi125pt.py comments) are ``box_symmetry_class``.

DEFAULT_PARAMS mirrors the reference's test coefficients
(ref: stencils/fake.h:11-33) so numeric results are directly comparable.

Original: ``bricklib_tpu/stencils/common.py``.
"""

from __future__ import annotations

import itertools

from ..st import ConstRef, Grid, Index


def indices(dims: int) -> list[Index]:
    return [Index(d) for d in range(dims)]


def star(grid: Grid, radius: int, coeffs: list) -> object:
    """Σ_r Σ_axis c_r · in(±r along axis); coeffs[0] is the center."""
    idx = indices(grid.dims)
    calc = coeffs[0] * grid(*idx)
    for r in range(1, radius + 1):
        for d in range(grid.dims):
            for s in (1, -1):
                args = list(idx)
                args[d] = idx[d] + s * r
                calc = calc + coeffs[r] * grid(*args)
    return calc


def directional_star(grid: Grid, coeffs: list) -> object:
    """Radius-1 star with a distinct coefficient per direction, ordered
    center, +dim0, -dim0, +dim1, -dim1, ... (ref: stencils/7pt.py)."""
    idx = indices(grid.dims)
    calc = coeffs[0] * grid(*idx)
    c = 1
    for d in range(grid.dims):
        for s in (1, -1):
            args = list(idx)
            args[d] = idx[d] + s
            calc = calc + coeffs[c] * grid(*args)
            c += 1
    return calc


def box_offsets(dims: int, radius: int) -> list[tuple[int, ...]]:
    """All (2r+1)^dims offset tuples in lexicographic order, outermost
    dimension slowest (the coeff[0..26] order of ref: 3axis.cpp d3pt27)."""
    rng = range(-radius, radius + 1)
    return [tuple(reversed(t)) for t in
            itertools.product(*([rng] * dims))]
    # note: product varies the LAST factor fastest; reversing each tuple
    # makes dim 0 (innermost subscript) vary fastest, so enumeration order
    # is k-slowest like the reference's coeff numbering.


def box(grid: Grid, radius: int, coeff_fn) -> object:
    """Dense cube: Σ coeff_fn(offs) · in(i+offs)."""
    idx = indices(grid.dims)
    calc = None
    for offs in box_offsets(grid.dims, radius):
        args = [idx[d] + offs[d] if offs[d] else idx[d]
                for d in range(grid.dims)]
        term = coeff_fn(offs) * grid(*args)
        calc = term if calc is None else calc + term
    return calc


def box_symmetry_class(offs: tuple[int, ...]) -> int:
    """Symmetry class of a 5^3 cube tap: index into the 10 constants of
    mpi125pt, keyed by the sorted |offset| signature
    (ref: stencils/mpi125pt.py comments: 000,001,002,011,012,022,111,112,
    122,222)."""
    sig = tuple(sorted(abs(o) for o in offs))
    classes = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 1), (0, 1, 2),
               (0, 2, 2), (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2)]
    return classes.index(sig)


# -- default test coefficients (ref: stencils/fake.h:11-33) ----------------
DEFAULT_PARAMS = {
    "MPI_BETA": 0.1,
    "MPI_ALPHA": 0.4,
    "MPI_A0": 0.1, "MPI_A1": 0.06, "MPI_A2": 0.045, "MPI_A3": 0.03,
    "MPI_A4": 0.015,
    "MPI_B0": 0.4, "MPI_B1": 0.07, "MPI_B2": 0.03,
    "MPI_C0": 0.1, "MPI_C1": 0.04, "MPI_C2": 0.03, "MPI_C3": 0.01,
    "MPI_C4": 0.006, "MPI_C5": 0.004, "MPI_C6": 0.005, "MPI_C7": 0.002,
    "MPI_C8": 0.003, "MPI_C9": 0.001,
}


CORPUS = ["s7pt", "cond", "s27pt", "mpi7pt", "mpi9pt", "mpi13pt",
          "mpi25pt", "mpi125pt"]


def bench_params(extra: dict | None = None) -> dict:
    """DEFAULT_PARAMS plus the canonical 27-coefficient fill every
    driver/bench/CLI uses (``coeff[c] = 0.03*(c+1)`` — distinct
    nonzero values so 27pt symmetry bugs can't cancel), optionally
    merged with user values.  The one shared definition: the CLI's
    reported factorization must match what Problem actually builds."""
    p = dict(DEFAULT_PARAMS)
    p["coeff"] = [0.03 * (c + 1) for c in range(27)]
    if extra:
        p.update(extra)
    return p


def stencil_by_name(name: str):
    """Load a corpus stencil; returns the list of StencilDef."""
    import importlib

    from ..st import load_stencil_module

    mod = importlib.import_module(f".{name}", __package__)
    # corpus modules build fresh Grid objects at import; reload so repeated
    # loads (tests) don't share assigned state
    mod = importlib.reload(mod)
    return load_stencil_module(mod)


def coeff_refs(name: str, n: int) -> list[ConstRef]:
    """[ConstRef("name[0]"), ...] — the reference's array-constant idiom."""
    return [ConstRef(f"{name}[{c}]") for c in range(n)]
