"""Opaque n-ary functions (ref: codegen/st/func.py).

The reference prints these as C calls (e.g. ``max(a, b)``); here the name
selects an array op at evaluation time (see codegen/evaluate.py FUNC_MAP).

Original: ``bricklib_tpu/st/func.py``.
"""

from __future__ import annotations

from .expr import Expr, conv_expr


class Func:
    def __init__(self, name: str, arity: int):
        self.name = name
        self.arity = int(arity)

    def __call__(self, *args) -> "CallExpr":
        if len(args) != self.arity:
            raise ValueError(
                f"Func {self.name} takes {self.arity} args, got {len(args)}")
        return CallExpr(self, *args)


class CallExpr(Expr):
    __slots__ = ("callee",)

    def __init__(self, func: Func, *args):
        super().__init__([conv_expr(a) for a in args])
        self.callee = func

    def __repr__(self):
        return f"{self.callee.name}({', '.join(map(repr, self.children))})"
