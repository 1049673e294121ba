"""Skin orderings: the order surface sections are laid out in storage.

``skin3d_good`` is the 26-entry surface order from the reference
(src/brick-mpi.cpp:25-52, from the PPoPP'21 paper) that minimizes the
number of per-neighbor discontiguities — the property that makes each
neighbor's ghost/skin set one (or few) contiguous storage runs, i.e. the
pack-free exchange.  ``skin3d_normal`` (lexicographic sweep, includes the
empty set which the planner skips) and ``skin3d_bad`` (interleaved with
empty separators) exist for comparison, as in the reference
(src/brick-mpi.cpp:54-136).

Entries are tuples of direction tags; tag +d / -d = upper / lower face of
dimension d, d=1 innermost (see utils/bitset.py).

Original: ``bricklib_tpu/comm/skin.py``.
"""

from __future__ import annotations

import itertools

from ..utils.bitset import BitSet

skin3d_good = [BitSet(t) for t in [
    (1,), (1, -3), (1, 2, -3), (1, 2), (1, 2, 3), (2, 3), (2,), (2, -3),
    (-1, 2, -3), (-1, 2), (-1, 2, 3), (-1, 3), (-1,), (-3,), (-1, -3),
    (-1, -2, -3), (-1, -2), (-1, -2, 3), (-2, 3), (-2,), (-2, -3),
    (1, -2, -3), (1, -2), (1, -2, 3), (1, 3), (3,),
]]

skin3d_normal = [BitSet(t) for t in [
    (-1, -2, -3), (-2, -3), (1, -2, -3), (-1, -3), (-3,), (1, -3),
    (-1, 2, -3), (2, -3), (1, 2, -3), (-1, -2), (-2,), (1, -2), (-1,), (),
    (1,), (-1, 2), (2,), (1, 2), (-1, -2, 3), (-2, 3), (1, -2, 3),
    (-1, 3), (3,), (1, 3), (-1, 2, 3), (2, 3), (1, 2, 3),
]]

# every second entry empty: forces a storage break between all sections
skin3d_bad = []
for _s in skin3d_normal:
    if _s:
        skin3d_bad.append(_s)
        skin3d_bad.append(BitSet())


def skin_lex(dim: int) -> list[BitSet]:
    """Lexicographic skin order for arbitrary rank (the reference ships
    3-D lists only; 4-D drivers use the same machinery via this order)."""
    out = []
    for combo in itertools.product((-1, 0, 1), repeat=dim):
        if all(c == 0 for c in combo):
            continue
        out.append(BitSet([c * (d + 1) for d, c in enumerate(combo) if c]))
    return out


def skinlist_by_name(name: str, dim: int = 3) -> list[BitSet]:
    if dim == 3:
        table = {"good": skin3d_good, "normal": skin3d_normal,
                 "bad": skin3d_bad, "lex": skin_lex(3)}
        if name in table:
            return table[name]
        raise KeyError(name)
    if name in ("good", "normal", "lex"):
        return skin_lex(dim)
    raise KeyError(f"no skin order {name!r} for dim={dim}")
