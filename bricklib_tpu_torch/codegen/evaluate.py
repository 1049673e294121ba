"""Generic stencil-expression evaluator.

One evaluator serves every backend: the reference needs nine ISA-specific
emitters because it prints source text (codegen/st/codegen/backend/*); here
the AST is evaluated against whatever array namespace the caller provides —
numpy, jnp on HBM arrays, or jnp on VMEM values *inside a Pallas kernel*
(the TPU replacement for printing CUDA/AVX intrinsics).

The caller supplies:
- ``read_tap(grid_name, offsets_edsl)`` — materialize a shifted read.
  Offsets are in eDSL order (dim 0 = innermost).
- ``resolve_const(name)`` — value for a ``ConstRef`` spelling.

Original: ``bricklib_tpu/codegen/evaluate.py``.  Passing ``xp=torch``
evaluates with :class:`TorchNS`, which takes a Python scalar beside a
tensor where ``torch.maximum`` and friends refuse one.
"""

from __future__ import annotations

import math
import re

import torch

from ..st.expr import BinOp, ConstRef, Expr, FloatLiteral, If, IntLiteral, Op, UnOp, UOp
from ..st.func import CallExpr
from ..st.grid import GridRef


class TorchNS:
    """The array namespace the evaluator expects, on tensors
    (``torch.maximum`` and friends refuse Python scalars)."""

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(a):
            a, b = b, a
        return (torch.maximum(a, b) if torch.is_tensor(b)
                else torch.clamp(a, min=b))

    @staticmethod
    def minimum(a, b):
        if not torch.is_tensor(a):
            a, b = b, a
        return (torch.minimum(a, b) if torch.is_tensor(b)
                else torch.clamp(a, max=b))

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    abs = staticmethod(lambda v: torch.abs(v) if torch.is_tensor(v)
                       else abs(v))
    sqrt = staticmethod(lambda v: torch.sqrt(v) if torch.is_tensor(v)
                        else math.sqrt(v))
    exp = staticmethod(lambda v: torch.exp(v) if torch.is_tensor(v)
                       else math.exp(v))
    log = staticmethod(lambda v: torch.log(v) if torch.is_tensor(v)
                       else math.log(v))
    logical_not = staticmethod(torch.logical_not)
    logical_and = staticmethod(torch.logical_and)
    logical_or = staticmethod(torch.logical_or)


def _make_func_map(xp):
    return {
        "max": xp.maximum,
        "min": xp.minimum,
        "abs": xp.abs,
        "sqrt": xp.sqrt,
        "exp": xp.exp,
        "log": xp.log,
    }


_IDX_RE = re.compile(r"^([A-Za-z_]\w*)\[(\d+)\]$")
_NUM_RE = re.compile(r"^-?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def resolve_const_from_params(params: dict):
    """Resolver for the reference's ConstRef spellings: ``coeff[3]`` indexes
    ``params['coeff']``, ``MPI_ALPHA`` looks up ``params['MPI_ALPHA']``,
    and ``0.2`` is a literal (ref: stencils/7pt.py, mpi7pt.py, mpi9pt.py).
    """

    def resolve(name: str):
        m = _IDX_RE.match(name)
        if m:
            return params[m.group(1)][int(m.group(2))]
        if name in params:
            return params[name]
        if _NUM_RE.match(name):
            return float(name)
        raise KeyError(f"unresolved ConstRef {name!r}; params has "
                       f"{sorted(params)}")

    return resolve


def evaluate(expr: Expr, read_tap, resolve_const, xp, cache=None):
    """Evaluate an AST to an array (or scalar) in namespace ``xp``.

    Repeated tap reads and SHARED subtree nodes are memoized (``cache``
    may be passed in to share the memo across several evaluations of
    one kernel row) — the evaluation-time analog of the reference
    codegen's CSE indexing (codegen/st/codegen/base.py:108-170): each
    distinct read/sub-DAG costs one VPU row value no matter how many
    expressions reference it."""
    if xp is torch:
        xp = TorchNS
    funcs = _make_func_map(xp)
    if cache is None:
        cache = {}

    def ev(e):
        key = id(e)
        if key in cache:
            return cache[key]
        v = _ev(e)
        cache[key] = v
        return v

    def _ev(e):
        if isinstance(e, GridRef):
            tkey = (e.grid.name, tuple(e.offsets))
            if tkey not in cache:
                cache[tkey] = read_tap(e.grid.name, tuple(e.offsets))
            return cache[tkey]
        if isinstance(e, ConstRef):
            return resolve_const(e.name)
        if isinstance(e, IntLiteral):
            return e.val
        if isinstance(e, FloatLiteral):
            return e.val
        if isinstance(e, If):
            return xp.where(ev(e.cond), ev(e.then), ev(e.otherwise))
        if isinstance(e, CallExpr):
            fn = funcs.get(e.callee.name)
            if fn is None:
                raise KeyError(f"unknown stencil function {e.callee.name!r}")
            return fn(*[ev(c) for c in e.children])
        if isinstance(e, UnOp):
            v = ev(e.subexpr)
            if e.op is UOp.NEG:
                return -v
            if e.op is UOp.POS:
                return v
            if e.op is UOp.NOT:
                return xp.logical_not(v)
        if isinstance(e, BinOp):
            a, b = ev(e.lhs), ev(e.rhs)
            if e.op is Op.ADD:
                return a + b
            if e.op is Op.SUB:
                return a - b
            if e.op is Op.MUL:
                return a * b
            if e.op is Op.DIV:
                return a / b
            if e.op is Op.MOD:
                return a % b
            if e.op is Op.GT:
                return a > b
            if e.op is Op.LT:
                return a < b
            if e.op is Op.GE:
                return a >= b
            if e.op is Op.LE:
                return a <= b
            if e.op is Op.EQ:
                return a == b
            if e.op is Op.NE:
                return a != b
            if e.op is Op.AND:
                return xp.logical_and(a, b)
            if e.op is Op.OR:
                return xp.logical_or(a, b)
        raise TypeError(f"cannot evaluate node {e!r}")

    return ev(expr)
