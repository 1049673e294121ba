"""Exchanges on one device, on tensors; the decomposition planner is the
reference's own (``bricklib_tpu/comm/decomp.py``, numpy only)."""

from bricklib_tpu.comm import BrickDecomp, skinlist_by_name

from .exchange import (copy_intervals, copy_intervals_plain, exchange_shift,
                       shift_exchange, shift_stages)
from .strong import (StrongDecomp, exchange_strong_remote,
                     exchange_strong_shift, stage_copy, stage_copy_plain,
                     strong_exchange, strong_stages)

__all__ = ["BrickDecomp", "skinlist_by_name", "copy_intervals",
           "copy_intervals_plain", "exchange_shift", "shift_exchange",
           "shift_stages", "StrongDecomp", "exchange_strong_remote",
           "exchange_strong_shift", "stage_copy", "stage_copy_plain",
           "strong_exchange", "strong_stages"]
