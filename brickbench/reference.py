"""The plain reference: iterated stencils on a dense periodic domain in
plain PyTorch, and the comparison that decides ``correct``.

It imports nothing of the port or of JAX and takes nothing the port has
made: it starts from the dense field the harness drew from the seed and
reads the taps from :mod:`brickbench.stencils`.
"""

from __future__ import annotations

import torch

CHUNK = 16  # rows of the outermost axis compared at a time

def iterate(field: torch.Tensor, taps, iters: int,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """``iters`` iterations of ``out[x] = sum_t c_t * in[x + o_t]`` on the
    periodic domain ``field``, computed in ``dtype`` (default: the
    field's), taps in table order."""
    f = field.to(dtype or field.dtype, copy=True)
    nd = f.dim()
    for _ in range(iters):
        out = torch.zeros_like(f)
        for off, c in taps:
            shifts = [-o for o in off if o]
            dims = [a for a in range(nd) if off[a]]
            src = torch.roll(f, shifts, dims) if dims else f
            out.add_(src, alpha=c)
            del src
        f = out
    return f


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between ``got`` and ``want`` over the largest
    magnitude of ``want``, in float64; infinity where ``got`` holds a
    value that is not finite."""
    gap = scale = 0.0
    for g, w in zip(got.split(CHUNK), want.split(CHUNK)):
        g64, w64 = g.double(), w.double()
        if not bool(torch.isfinite(g64).all()):
            return float("inf")
        scale = max(scale, float(w64.abs().max()))
        gap = max(gap, float((g64 - w64).abs().max()))
    return gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))
