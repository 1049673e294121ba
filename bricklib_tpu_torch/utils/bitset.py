"""Neighbor-direction sets encoded in a single integer.

A ``BitSet`` holds a set of nonzero dimension tags in ``[-32, 32]``.  Tag
``+d`` means "the upper face along dimension d" and ``-d`` the lower face;
the set {1, -3} therefore names the edge neighbor that is +1 in dim 1 and
-1 in dim 3.  Dimension tags are 1-based (dim 1 = innermost / contiguous),
matching the reference's convention (ref: include/bitset.h:18-177).

Encoding: bit ``d-1`` for ``+d`` and bit ``32 + (-d) - 1`` for ``-d``, so
the whole set fits a uint64 usable as a dict key (the reference's
``rank_map`` is keyed the same way, ref: include/brick-mpi.h:744).

Original: ``bricklib_tpu/utils/bitset.py``.
"""

from __future__ import annotations

from typing import Iterable, Iterator


class BitSet:
    """Immutable set of direction tags in [-32, -1] ∪ [1, 32]."""

    __slots__ = ("set",)

    def __init__(self, elems: "Iterable[int] | int | BitSet" = ()):
        if isinstance(elems, BitSet):
            object.__setattr__(self, "set", elems.set)
            return
        if isinstance(elems, int):
            # Raw uint64 value (matches reference BitSet(uint64_t))
            object.__setattr__(self, "set", elems & ((1 << 64) - 1))
            return
        v = 0
        for e in elems:
            v |= BitSet._bit(e)
        object.__setattr__(self, "set", v)

    @staticmethod
    def _bit(e: int) -> int:
        if e == 0 or not (-32 <= e <= 32):
            raise ValueError(f"BitSet element out of range: {e}")
        return 1 << (e - 1) if e > 0 else 1 << (32 + (-e) - 1)

    def __setattr__(self, name, value):  # immutability guard
        raise AttributeError("BitSet is immutable")

    # -- queries ---------------------------------------------------------
    def get(self, e: int) -> bool:
        return bool(self.set & BitSet._bit(e))

    def __contains__(self, e: int) -> bool:
        return self.get(e)

    def size(self) -> int:
        return bin(self.set).count("1")

    def __len__(self) -> int:
        return self.size()

    def __bool__(self) -> bool:
        return self.set != 0

    def __iter__(self) -> Iterator[int]:
        for d in range(1, 33):
            if self.get(d):
                yield d
        for d in range(1, 33):
            if self.get(-d):
                yield -d

    def elements(self):
        return sorted(self, key=abs)

    # -- algebra (ref: include/bitset.h operator overloads) ---------------
    def flip(self, e: int) -> "BitSet":
        return BitSet(self.set ^ BitSet._bit(e))

    def __and__(self, o: "BitSet") -> "BitSet":
        return BitSet(self.set & o.set)

    def __or__(self, o: "BitSet") -> "BitSet":
        return BitSet(self.set | o.set)

    def __xor__(self, o: "BitSet") -> "BitSet":
        return BitSet(self.set ^ o.set)

    def __invert__(self) -> "BitSet":
        """Negate every element: {1,-3} -> {-1,3} (reference's ``!``)."""
        lo = self.set & 0xFFFFFFFF
        hi = (self.set >> 32) & 0xFFFFFFFF
        return BitSet((lo << 32) | hi)

    def __le__(self, o: "BitSet") -> bool:
        """Subset test (reference's ``<=``)."""
        return (self.set & o.set) == self.set

    def __ge__(self, o: "BitSet") -> bool:
        return (self.set & o.set) == o.set

    def __eq__(self, o) -> bool:
        return isinstance(o, BitSet) and self.set == o.set

    def __hash__(self) -> int:
        return hash(self.set)

    def __repr__(self) -> str:
        return "BitSet({" + ", ".join(str(e) for e in self.elements()) + "})"


def allneighbors(dim: int) -> list[BitSet]:
    """All 3^dim neighbor sets (including the empty set), in the order the
    reference enumerates them (ref: src/brick-mpi.cpp:9-23): recursive over
    dims 1..dim choosing (+, none, -) — i.e. for each dim in increasing
    order, '+' branch first, then absent, then '-'.
    """
    out: list[BitSet] = []

    def rec(cur: BitSet, d: int):
        if d > dim:
            out.append(cur)
            return
        rec(cur.flip(d), d + 1)
        rec(cur, d + 1)
        rec(cur.flip(-d), d + 1)

    rec(BitSet(), 1)
    return out
