"""Original: ``bricklib_tpu/utils/__init__.py``."""

from .bitset import BitSet
from .zmort import ZMort

__all__ = ["BitSet", "ZMort"]
