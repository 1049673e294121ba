"""AST nodes for the stencil language (ref: codegen/st/expr.py).

A fresh, compact implementation: nodes are plain classes with a
``children`` list; arithmetic/comparison operators build ``BinOp`` trees.
Unlike the reference (which prints C code), these trees are *evaluated*
against array backends (jnp / Pallas values), so the node set stops at
what stencils need: arithmetic, comparisons, If, opaque calls, grid
references.

Original: ``bricklib_tpu/st/expr.py``.
"""

from __future__ import annotations

import enum
from typing import Iterable


class Op(enum.Enum):
    # arithmetic
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    # comparisons
    EQ = "=="
    NE = "!="
    GT = ">"
    LT = "<"
    GE = ">="
    LE = "<="
    # logic
    AND = "&&"
    OR = "||"


class UOp(enum.Enum):
    NEG = "-"
    POS = "+"
    NOT = "!"


def conv_expr(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        raise TypeError("bool literal not supported in stencil expressions")
    if isinstance(v, int):
        return IntLiteral(v)
    if isinstance(v, float):
        return FloatLiteral(v)
    if isinstance(v, str):
        return ConstRef(v)
    raise TypeError(f"cannot convert to stencil expression: {v!r}")


class Expr:
    """Base AST node; children in ``self.children``."""

    __slots__ = ("children",)

    def __init__(self, children: Iterable["Expr"] = ()):
        self.children = list(children)

    # -- traversal -------------------------------------------------------
    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    # -- operator sugar ---------------------------------------------------
    def _bin(self, op, other, swap=False):
        other = conv_expr(other)
        return BinOp(op, other, self) if swap else BinOp(op, self, other)

    def __add__(self, o):
        return self._bin(Op.ADD, o)

    def __radd__(self, o):
        return self._bin(Op.ADD, o, swap=True)

    def __sub__(self, o):
        return self._bin(Op.SUB, o)

    def __rsub__(self, o):
        return self._bin(Op.SUB, o, swap=True)

    def __mul__(self, o):
        return self._bin(Op.MUL, o)

    def __rmul__(self, o):
        return self._bin(Op.MUL, o, swap=True)

    def __truediv__(self, o):
        return self._bin(Op.DIV, o)

    def __rtruediv__(self, o):
        return self._bin(Op.DIV, o, swap=True)

    def __mod__(self, o):
        return self._bin(Op.MOD, o)

    def __neg__(self):
        return UnOp(UOp.NEG, self)

    def __pos__(self):
        return UnOp(UOp.POS, self)

    # comparisons produce predicate expressions for If(...)
    def __gt__(self, o):
        return self._bin(Op.GT, o)

    def __lt__(self, o):
        return self._bin(Op.LT, o)

    def __ge__(self, o):
        return self._bin(Op.GE, o)

    def __le__(self, o):
        return self._bin(Op.LE, o)

    def logical_and(self, o):
        return self._bin(Op.AND, o)

    def logical_or(self, o):
        return self._bin(Op.OR, o)

    def eq(self, o):
        return self._bin(Op.EQ, o)

    def ne(self, o):
        return self._bin(Op.NE, o)


class Index(Expr):
    """Iteration index for dimension ``n``; ``Index(0)`` is the
    innermost/contiguous dimension (ref: codegen/st/expr.py Index)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def __repr__(self):
        return f"Index({self.n})"


class IntLiteral(Expr):
    __slots__ = ("val",)

    def __init__(self, val: int):
        super().__init__()
        self.val = int(val)

    def __repr__(self):
        return f"IntLiteral({self.val})"


class FloatLiteral(Expr):
    __slots__ = ("val",)

    def __init__(self, val: float):
        super().__init__()
        self.val = float(val)

    def __repr__(self):
        return f"FloatLiteral({self.val})"


class ConstRef(Expr):
    """Named runtime constant, resolved from a params mapping at execution.

    The reference splices the name into C source (``ConstRef("coeff[0]")``,
    ``ConstRef("MPI_ALPHA")``, ``ConstRef("0.2")``); here the same spellings
    resolve against a dict: ``name[idx]`` indexes ``params[name]``, a bare
    name looks up ``params[name]``, and a numeric spelling is a literal.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        super().__init__()
        self.name = str(name)

    def __repr__(self):
        return f"ConstRef({self.name!r})"


class BinOp(Expr):
    __slots__ = ("op",)

    def __init__(self, op: Op, lhs, rhs):
        super().__init__([conv_expr(lhs), conv_expr(rhs)])
        self.op = op

    @property
    def lhs(self):
        return self.children[0]

    @property
    def rhs(self):
        return self.children[1]

    def __repr__(self):
        return f"({self.lhs!r} {self.op.value} {self.rhs!r})"


class UnOp(Expr):
    __slots__ = ("op",)

    def __init__(self, op: UOp, sub):
        super().__init__([conv_expr(sub)])
        self.op = op

    @property
    def subexpr(self):
        return self.children[0]

    def __repr__(self):
        return f"({self.op.value}{self.subexpr!r})"


class If(Expr):
    """Ternary select (ref: codegen/st/expr.py If) — lowers to where()."""

    def __init__(self, cond, then, otherwise):
        super().__init__([conv_expr(cond), conv_expr(then),
                          conv_expr(otherwise)])

    @property
    def cond(self):
        return self.children[0]

    @property
    def then(self):
        return self.children[1]

    @property
    def otherwise(self):
        return self.children[2]
