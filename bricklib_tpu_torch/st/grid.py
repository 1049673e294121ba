"""Grid symbols and affine index extraction (ref: codegen/st/grid.py).

``Grid("bIn", 3)`` declares a 3-D field; calling it with index expressions
(``input(i + 1, j, k - 2)``) produces a ``GridRef`` carrying the integer
offset per dimension.  Index arguments must be affine with unit
coefficient: ``Index ± literal``.  The reference extracts offsets with a
complex-number evaluation trick (codegen/st/grid.py:eval_offset); here the
tree is walked structurally.

``output(i, j, k).assign(rhs)`` records the stencil output, and calling an
assigned grid re-yields it so ``STENCIL = [output]`` works.

Original: ``bricklib_tpu/st/grid.py``.
"""

from __future__ import annotations

from .expr import BinOp, Expr, Index, IntLiteral, Op, UnOp, UOp, conv_expr


def eval_offset(idx_expr: Expr) -> tuple[Index | None, int, int]:
    """Return (index_var, coefficient, offset) for an affine index expr."""
    if isinstance(idx_expr, Index):
        return idx_expr, 1, 0
    if isinstance(idx_expr, IntLiteral):
        return None, 0, idx_expr.val
    if isinstance(idx_expr, UnOp):
        var, coef, off = eval_offset(idx_expr.subexpr)
        if idx_expr.op is UOp.NEG:
            return var, -coef, -off
        if idx_expr.op is UOp.POS:
            return var, coef, off
        raise ValueError(f"non-affine index expression: {idx_expr!r}")
    if isinstance(idx_expr, BinOp):
        lv, lc, lo = eval_offset(idx_expr.lhs)
        rv, rc, ro = eval_offset(idx_expr.rhs)
        if idx_expr.op is Op.ADD:
            var = _merge_var(lv, rv)
            return var, lc + rc, lo + ro
        if idx_expr.op is Op.SUB:
            var = _merge_var(lv, rv)
            return var, lc - rc, lo - ro
        if idx_expr.op is Op.MUL:
            # only literal * affine or affine * literal
            if lv is None and lc == 0:
                return rv, rc * lo, ro * lo
            if rv is None and rc == 0:
                return lv, lc * ro, lo * ro
        raise ValueError(f"non-affine index expression: {idx_expr!r}")
    raise ValueError(f"bad index expression: {idx_expr!r}")


def _merge_var(a, b):
    if a is not None and b is not None and a is not b:
        raise ValueError("more than one Index in a grid subscript")
    return a if a is not None else b


class Grid:
    """A named multi-dimensional field symbol."""

    def __init__(self, name: str, dims: int):
        self.name = name
        self.dims = int(dims)
        self.out: tuple[GridRef, Expr] | None = None

    def __call__(self, *indices) -> "GridRef":
        if self.out is not None:
            # An assigned grid re-yields its output ref (reference behavior:
            # codegen/st/grid.py Grid.__call__).
            return self.out[0]
        return GridRef(self, list(indices))

    def __repr__(self):
        return f"Grid({self.name!r}, {self.dims})"


class GridRef(Expr):
    """A shifted read of a grid: carries per-dimension integer offsets,
    innermost dimension first (matching ``Index(0)`` = contiguous)."""

    __slots__ = ("grid", "indices", "offsets")

    def __init__(self, grid: Grid, indices: list):
        super().__init__()
        if len(indices) != grid.dims:
            raise ValueError(
                f"grid {grid.name} has {grid.dims} dims, got "
                f"{len(indices)} indices")
        self.grid = grid
        self.indices = []
        self.offsets = []
        seen = {}
        for d, idx in enumerate(indices):
            idx = conv_expr(idx)
            var, coef, off = eval_offset(idx)
            if var is None or coef != 1:
                raise ValueError(
                    f"grid subscript {d} of {grid.name} must be Index ± "
                    f"literal, got {idx!r}")
            if var.n in seen:
                raise ValueError(f"Index({var.n}) used twice in one subscript")
            seen[var.n] = d
            self.indices.append(var)
            self.offsets.append(int(off))

    def assign(self, rhs):
        if any(o != 0 for o in self.offsets):
            raise ValueError("output reference must be unshifted")
        self.grid.out = (self, conv_expr(rhs))

    @property
    def rhs(self) -> Expr:
        assert self.grid.out is not None and self.grid.out[0] is self
        return self.grid.out[1]

    def __repr__(self):
        return f"GridRef({self.grid.name}, offsets={self.offsets})"
