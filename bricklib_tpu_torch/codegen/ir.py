"""Stencil IR: the analysis the emitters share.

The reference's CodeGen pipeline (codegen/st/codegen/base.py:108-676) CSEs
the DAG, flattens +/× chains into Reduction nodes, and greedily groups
shifted reads to minimize distinct vector loads.  On TPU the compiler
(XLA/Mosaic) does instruction scheduling and CSE, so the IR keeps only the
transformations that still pay off at the array level:

- ``linear_decomposition`` — recognize Σ cᵍ·in(offsets) and group taps by
  coefficient, turning k multiplies into one multiply per coefficient
  group (125pt: 125 FMAs → 115 adds + 10 scalar multiplies).  This is the
  array-level analog of the reference's Reduction grouping
  (codegen/st/codegen/base.py:conv_reduction).
- radius/tap bookkeeping via :class:`..st.loader.StencilDef`.

Original: ``bricklib_tpu/codegen/ir.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..st.expr import BinOp, ConstRef, Expr, FloatLiteral, IntLiteral, Op, UnOp, UOp
from ..st.grid import GridRef
from ..st.loader import StencilDef


def _coeff_key(e: Expr):
    """Identity key for a coefficient expression, or None if not a simple
    constant."""
    if isinstance(e, ConstRef):
        return ("const", e.name)
    if isinstance(e, (IntLiteral, FloatLiteral)):
        return ("lit", float(e.val))
    return None


def _flatten_add(e: Expr, sign: int, out: list):
    if isinstance(e, BinOp) and e.op is Op.ADD:
        _flatten_add(e.lhs, sign, out)
        _flatten_add(e.rhs, sign, out)
    elif isinstance(e, BinOp) and e.op is Op.SUB:
        _flatten_add(e.lhs, sign, out)
        _flatten_add(e.rhs, -sign, out)
    elif isinstance(e, UnOp) and e.op is UOp.NEG:
        _flatten_add(e.subexpr, -sign, out)
    else:
        out.append((sign, e))


def linear_decomposition(rhs: Expr):
    """Decompose ``rhs`` as Σ sign · coeff · grid(offsets).

    Returns ``[(coeff_key, coeff_expr, [(sign, grid_name, offsets_edsl)])]``
    grouped by coefficient, or None if the expression is not a pure linear
    combination of taps (e.g. cond.py's If/max — those run through the
    generic evaluator instead).
    """
    terms: list[tuple[int, Expr]] = []
    _flatten_add(rhs, 1, terms)
    groups: dict = {}
    order: list = []
    for sign, t in terms:
        if isinstance(t, GridRef):
            key, cexpr, ref = ("lit", 1.0), FloatLiteral(1.0), t
        elif isinstance(t, BinOp) and t.op is Op.MUL:
            a, b = t.lhs, t.rhs
            if _coeff_key(a) is not None and isinstance(b, GridRef):
                key, cexpr, ref = _coeff_key(a), a, b
            elif _coeff_key(b) is not None and isinstance(a, GridRef):
                key, cexpr, ref = _coeff_key(b), b, a
            else:
                return None
        else:
            return None
        if key not in groups:
            groups[key] = (cexpr, [])
            order.append(key)
        groups[key][1].append((sign, ref.grid.name, tuple(ref.offsets)))
    return [(key, groups[key][0], groups[key][1]) for key in order]


def fold_linear(ir: "StencilIR", resolve, fields: dict | None = None):
    """Fold a linear stencil innermost-cost-first for the Pallas
    emitters (the VMEM-era form of the reference codegen's reduction
    grouping + greedy shift selection, codegen/st/codegen/base.py:
    conv_reduction/optGreedy).  Shifts distribute over sums and the
    three shift kinds have very different TPU costs — outer-dim slices
    are free, sublane (j) realignments cheap, lane (i) rolls move the
    whole row through the VPU — so:

      W[dj,di] = Σ_outer c·slice(outer offsets)   (free slices, MACs)
      V[di]    = Σ_dj jshift(W[dj,di], dj)        (one realign per dj)
      out      = Σ_di ishift(V[di], di)           (ONE op per distinct di)

    Returns ``(wdefs, vmap, jneed)`` or None for non-linear stencils:
    ``wdefs[wid] = [(coeff, (outer_offsets...,)), ...]`` with outer
    offsets outermost-first (3-D: ``(dk,)``; 4-D: ``(dw, dk)``),
    ``vmap[di] = ((dj, wid), ...)``, ``jneed = (jlo, jhi)``.
    Coefficients resolve to trace-time constants; identical k-profiles
    share a W, identical j-structures share a V (±di symmetry).

    ``fields`` (multi-input stencils): map grid name -> field index;
    each outer-offset tuple is then ``(fidx, dk, ...)`` so taps from
    different input grids never collapse into one k-profile.  The
    single-input form stays ``(dk, ...)`` (every emitter's default).
    """
    if ir.linear is None:
        return None
    C: dict = {}
    for _key, cexpr, taps in ir.linear:
        c = float(resolve(cexpr.name)) if hasattr(
            cexpr, "name") else float(cexpr.val)
        for sign, gname, offs in taps:
            free = tuple(reversed(offs[2:]))
            if fields is not None:
                free = (fields[gname],) + free
            key = (free, offs[1], offs[0])
            C[key] = C.get(key, 0.0) + (c if sign > 0 else -c)
    kprof: dict = {}
    for (free, dj, di), c in C.items():
        kprof.setdefault((dj, di), []).append((free, c))
    wdefs: list = []
    wkey_to_id: dict = {}
    wid_of: dict = {}
    for col, terms in kprof.items():
        by_c: dict = {}
        for fr, c in sorted(terms):
            by_c.setdefault(c, []).append(fr)
        wkey = tuple(sorted((c, tuple(frs))
                            for c, frs in by_c.items()))
        if wkey not in wkey_to_id:
            wkey_to_id[wkey] = len(wdefs)
            wdefs.append(list(wkey))
        wid_of[col] = wkey_to_id[wkey]
    vterms: dict = {}
    for (dj, di), wid in wid_of.items():
        vterms.setdefault(di, []).append((dj, wid))
    djs = [dj for (dj, _di) in wid_of]
    jneed = (max(0, -min(djs)), max(0, max(djs)))
    return (wdefs, {di: tuple(sorted(t)) for di, t in vterms.items()},
            jneed)


def additive_groups(rhs: Expr):
    """Coefficient grouping for the GENERIC (nonlinear) path: flatten
    the top-level +/- chain and group terms of the form ``coeff *
    subexpr`` by coefficient — the nonlinear generalization of
    :func:`linear_decomposition` (the reference groups arbitrary
    summands into Reduction nodes the same way,
    codegen/st/codegen/base.py:conv_reduction).  A stencil like
    ``Σ c_g · f(tap_t)`` with repeated symmetry coefficients then
    costs one multiply per GROUP instead of one per term.

    Returns ``[(coeff_expr, [(sign, subexpr), ...]), ...]`` or None
    when grouping saves nothing (fewer than 2 terms, or every group
    is a singleton)."""
    terms: list[tuple[int, Expr]] = []
    _flatten_add(rhs, 1, terms)
    if len(terms) < 2:
        return None
    groups: dict = {}
    order: list = []
    for i, (sign, t) in enumerate(terms):
        if isinstance(t, BinOp) and t.op is Op.MUL:
            a, b = t.lhs, t.rhs
            if _coeff_key(a) is not None:
                key, cexpr, sub = _coeff_key(a), a, b
            elif _coeff_key(b) is not None:
                key, cexpr, sub = _coeff_key(b), b, a
            else:
                key, cexpr, sub = ("u", i), FloatLiteral(1.0), t
        else:
            key, cexpr, sub = ("lit", 1.0), FloatLiteral(1.0), t
        if key not in groups:
            groups[key] = (cexpr, [])
            order.append(key)
        groups[key][1].append((sign, sub))
    if all(len(groups[k][1]) == 1 for k in order):
        return None
    return [(groups[k][0], groups[k][1]) for k in order]


def generic_pass_estimate(sdef: StencilDef) -> int:
    """VPU row-pass estimate for a NONLINEAR stencil on the generic
    evaluator path (the x-axis of the same measured VMEM-contention
    model :func:`vpu_pass_estimate` feeds for linear stencils): one
    pass per DISTINCT tap read (evaluation memoizes repeats) plus one
    per arithmetic/select/call node, minus the multiplies
    :func:`additive_groups` folds into per-group MACs."""
    from ..st.expr import If
    from ..st.func import CallExpr

    taps = set()
    ops = 0
    seen: set = set()    # shared sub-DAGs evaluate once (id-memoized)
    stack = [sdef.rhs]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, GridRef):
            taps.add((node.grid.name, tuple(node.offsets)))
        elif isinstance(node, (BinOp, UnOp, If, CallExpr)):
            ops += 1
            stack.extend(node.children)
    g = additive_groups(sdef.rhs)
    if g is not None:
        saved = sum(len(ts) - 1 for _c, ts in g)
        ops = max(0, ops - saved)
    return len(taps) + ops


# fuse only while DMA-bound: the measured VMEM-contention knee is ~40
# passes/row (docs/DESIGN.md); 30 leaves margin for the fused rings'
# own extension-row overhead (7pt 18 and 13pt 26 fuse; 27pt 46,
# 25pt 50 and 125pt 55 stay unfused — measured neutral-or-worse fused)
PASS_FUSE_MAX = 30


def vpu_pass_estimate(lin) -> int:
    """Estimated VPU row-passes per output row for a
    :func:`fold_linear` factorization — the x-axis of the measured
    VMEM-contention model (docs/DESIGN.md "QUANTIFIED FLOOR"): sweeps
    sit at the DMA floor up to ~40 passes, then each pass adds ~0.05
    ms at 512³ because compute and window DMA contend on VMEM
    bandwidth.  Counts k-slice sum adds, W FMAs, V j-shift extracts
    and adds, and i lane rolls and adds — the corpus fit used exactly
    this count (tap1 2, 7pt 18, 13pt 26, 27pt 46, 125pt 55)."""
    wdefs, vmap_, _ = lin
    ksum_adds = sum(len(dks) - 1
                    for dks in {d for t in wdefs for _c, d in t})
    wfma = sum(len(t) for t in wdefs)
    vsets = set(vmap_.values())
    vext = sum(len(t) for t in vsets)
    vadd = sum(len(t) - 1 for t in vsets)
    rolls = sum(1 for di in vmap_ if di)
    radd = len(vmap_) - 1
    return ksum_adds + wfma + vext + vadd + rolls + radd


@dataclass
class StencilIR:
    """Analyzed stencil ready for an emitter."""

    sdef: StencilDef
    linear: "list | None"

    @staticmethod
    def from_def(sdef: StencilDef) -> "StencilIR":
        return StencilIR(sdef=sdef, linear=linear_decomposition(sdef.rhs))

    @property
    def dims(self) -> int:
        return self.sdef.dims

    def radius(self):
        return self.sdef.radius()

    def flops_per_element(self) -> int:
        """Approximate FLOPs/element (for rooflines and CostEstimate)."""
        if self.linear is not None:
            taps = sum(len(g[2]) for g in self.linear)
            return 2 * taps
        return 2 * len(self.sdef.taps)
