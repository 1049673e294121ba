"""Stencil-expression eDSL.

Same contract as the reference's ``st`` package (ref: codegen/st/): a
stencil module declares ``Index`` objects, ``Grid`` symbols, builds an
expression with overloaded operators, calls ``output(i, j, k).assign(rhs)``
and exports ``STENCIL = [output]``.

Conventions (kept identical to the reference so stencil definitions are
interchangeable): ``Index(0)`` is the *innermost/contiguous* dimension;
grid calls take indices innermost-first: ``input(i + 1, j, k)`` reads one
element up along the contiguous axis.

Original: ``bricklib_tpu/st/__init__.py``.
"""

from .expr import (
    Expr,
    Index,
    ConstRef,
    IntLiteral,
    FloatLiteral,
    If,
    BinOp,
    UnOp,
    conv_expr,
)
from .grid import Grid, GridRef
from .func import Func, CallExpr
from .loader import load_stencil_module, StencilDef

__all__ = [
    "Expr",
    "Index",
    "ConstRef",
    "IntLiteral",
    "FloatLiteral",
    "If",
    "BinOp",
    "UnOp",
    "conv_expr",
    "Grid",
    "GridRef",
    "Func",
    "CallExpr",
    "load_stencil_module",
    "StencilDef",
]
