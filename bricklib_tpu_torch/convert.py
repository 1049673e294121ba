"""State carried over from the JAX package to the port.

Both packages keep brick storage as ``[nbricks, *bdims]`` over the same
grid tables, so a reference state converts element for element.  The
stencil's coefficients arrive as the reference's ``params`` dict (for
example ``bench_params()``) and leave as the resolved float32 tap table
that the sweep kernel takes.
"""

from __future__ import annotations

import numpy as np
import torch

from .codegen.taps import TapTable, as_ir, params_from_reference
from .core import require_device

__all__ = ["TapTable", "as_ir", "params_from_reference",
           "storage_from_reference"]


def storage_from_reference(np_storage, device) -> torch.Tensor:
    """A reference storage (numpy or anything ``np.asarray`` takes, such
    as a jax array) as a contiguous float32 tensor on ``device``."""
    host = np.ascontiguousarray(np.asarray(np_storage))
    if host.dtype != np.float32:
        raise ValueError(f"storage must be float32, got {host.dtype}")
    return torch.from_numpy(host.copy()).to(require_device(device))
