"""Rank-5+ stencils built with either package's eDSL (``st``), and the
dense twin of the port's rank-``nd`` pencil sweep, for the port's tests.
No JAX here, so the card-only tests can use it too."""

import torch

from bricklib_tpu_torch.core.setup import from_bricks


def star_nd(st, nd, two=False, corner=False, radius=1):
    """The ``2 nd + 1``-point star (radius 1 on every axis, distinct
    coefficients; ``radius`` moves the + taps out); ``two`` adds taps of
    a second input ``aux``; ``corner`` adds two taps that cross three axes
    at once."""
    idx = [st.Index(a) for a in range(nd)]
    g, o = st.Grid("in", nd), st.Grid("out", nd)

    def at(grid, moves):
        ii = list(idx)
        for a, d in moves.items():
            ii[a] = idx[a] + d
        return grid(*ii)

    e = 0.3 * g(*idx)
    for a in range(nd):
        for d in (radius, -1):
            e = e + (0.05 + 0.01 * a + 0.003 * d) * at(g, {a: d})
    if corner:
        e = e + 0.07 * at(g, {0: 1, 3: 1, 4: -1}) \
            - 0.02 * at(g, {1: -1, 2: 1, 4: 1})
    if two:
        h = st.Grid("aux", nd)
        e = e + 0.11 * at(h, {2: 1}) - 0.05 * at(h, {4: -1, 0: 1})
    o(*idx).assign(e)
    return st.load_stencil_module({"STENCIL": [o]})[0]


def nd_twin(xs, plan, dec):
    """The owned region of one rank-``nd`` sweep (``plan`` of the port's
    ``pencil_sweep_nd``) as dense tensor code: each input gathered to its
    dense block (ghosts of one brick on the outer axes, none in i), one
    slice per folded tap, rolled along the i row."""
    nd = len(plan.bdims)
    gz = plan.bdims[:-1] + (0,)
    dense = [from_bricks(x.view(dec.nbricks, -1), dec.grid, plan.bdims)
             for x in xs]
    inputs = (plan.taps.inputs.tolist() if plan.taps.inputs is not None
              else [0] * len(plan.taps.coeffs))
    acc = None
    for offs, c, f in zip(plan.taps.offsets.tolist(),
                          plan.taps.coeffs.tolist(), inputs):
        v = dense[f][tuple(slice(gz[a] + offs[a], gz[a] + offs[a]
                                 + dec.dims[a]) for a in range(nd - 1))]
        v = c * torch.roll(v, -offs[-1], dims=nd - 1)
        acc = v if acc is None else acc + v
    return acc
