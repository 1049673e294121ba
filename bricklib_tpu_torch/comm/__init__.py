"""One-device exchange on tensors; the decomposition planner is the
reference's own (``bricklib_tpu/comm/decomp.py``, numpy only)."""

from bricklib_tpu.comm import BrickDecomp, skinlist_by_name

from .exchange import (copy_intervals, copy_intervals_plain, exchange_shift,
                       shift_exchange, shift_stages)

__all__ = ["BrickDecomp", "skinlist_by_name", "copy_intervals",
           "copy_intervals_plain", "exchange_shift", "shift_exchange",
           "shift_stages"]
