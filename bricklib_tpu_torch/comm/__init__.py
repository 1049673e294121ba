"""The decomposition planner (``decomp``, ``skin``: numpy) and the
exchanges on one device, on tensors."""

from .decomp import BrickDecomp, Run, Section
from .exchange import (copy_intervals, copy_intervals_plain, exchange_shift,
                       shift_exchange, shift_stages)
from .strong import (StrongDecomp, exchange_strong_remote,
                     exchange_strong_shift, stage_copy, stage_copy_plain,
                     strong_exchange, strong_stages)
from .skin import (skin3d_bad, skin3d_good, skin3d_normal, skin_lex,
                   skinlist_by_name)

__all__ = ["BrickDecomp", "Run", "Section", "skin3d_bad", "skin3d_good",
           "skin3d_normal", "skin_lex", "skinlist_by_name", "copy_intervals",
           "copy_intervals_plain", "exchange_shift", "shift_exchange",
           "shift_stages", "StrongDecomp", "exchange_strong_remote",
           "exchange_strong_shift", "stage_copy", "stage_copy_plain",
           "strong_exchange", "strong_stages"]
