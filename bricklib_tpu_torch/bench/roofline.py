"""The copy roofline and dependent-chain timing (port of
``bricklib_tpu/bench/roofline.py``).

- :func:`make_dma_copy` — a whole-storage copy by kernel K3
  (``csrc/brick_copy.cu``), the roofline every step rate is judged
  against (2 x itemsize bytes moved per element);
- :func:`barrier` — ``torch.cuda.synchronize`` where there is a card;
- :func:`chain` — a dependent chain ``out = fn(out)`` timed with CUDA
  events after one warm-up call, over a tensor or a mesh state;
- :func:`bound` and :func:`sweep_work` — the least time the card could
  take for a kernel's work, and a sweep's bytes and operations.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .timing import Clock, devices_of

# one H100's published peaks (SXM, 700 W): device-memory bytes/s and f32
# operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def copy_storage_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel K3."""
    return x.clone()


def copy_storage(x: torch.Tensor) -> torch.Tensor:
    """A fresh copy of ``x``: the plain version for a CPU tensor, kernel
    K3 for a CUDA tensor."""
    if not x.is_contiguous():
        raise ValueError("copy_storage takes contiguous storage")
    if x.device.type == "cpu":
        return copy_storage_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"kernel K3 runs on CUDA tensors, got {x.device}")
    nbytes = x.numel() * x.element_size()
    if nbytes % 16 or nbytes == 0:
        raise ValueError(f"kernel K3 copies 16-byte vectors; storage is "
                         f"{nbytes} bytes")
    out = torch.empty_like(x)
    err = _build.library().bt_copy_storage(
        x.data_ptr(), out.data_ptr(), nbytes // 16,
        _build.stream_handle(x.device))
    _build.check(err, "copy_storage")
    copy_storage.launches += 1
    return out


copy_storage.launches = 0


def make_dma_copy(nbricks: int, bdims, dtype=torch.float32):
    """Whole-storage copy ``fn(view) -> view'`` over ``[nbricks,
    *bdims]``."""
    shape = (int(nbricks),) + tuple(int(b) for b in bdims)

    def fn(view: torch.Tensor) -> torch.Tensor:
        if tuple(view.shape) != shape or view.dtype != dtype:
            raise ValueError(f"copy of {shape} {dtype}, got "
                             f"{tuple(view.shape)} {view.dtype}")
        return copy_storage(view)

    return fn


def barrier() -> None:
    """Wait for the card (no-op on the CPU, where PyTorch is eager)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def chain(fn, x, it: int):
    """(avg seconds, last output) of ``it`` dependent calls after one
    warm-up call, over a tensor or a mesh state (a list of tensors on one
    or more cards): CUDA events on cards (``timing.Clock``: from the first
    card's start to the last card's end), ``time.perf_counter`` on the
    CPU."""
    out = fn(x)
    clock = Clock(devices_of([x]))
    if clock.cuda:
        for d in clock.devices:
            torch.cuda.synchronize(d)
    t0 = clock.start()
    for _ in range(it):
        out = fn(out)
    return clock.seconds(t0, clock.mark()) / it, out


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` through device memory and do ``flops`` f32 operations."""
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def sweep_work(plan) -> tuple[int, int]:
    """(bytes, f32 operations) one sweep (K1, K4 or K6) must move and do:
    each brick it reads through the table (the output bricks and their
    neighbours, whole) read once per input field, each brick it writes
    written once per output, and a multiply and an add per folded tap,
    output element and fused level."""
    t = plan.table
    if hasattr(plan, "y_range"):
        ranges, nin, nout = (plan.y_range,), len(plan.fields), len(plan.taps)
        ntaps, batch, stride = sum(len(x) for x in plan.taps), 1, 0
    else:
        ranges, nin, nout = plan.ranges, 1, 1
        ntaps = len(plan.taps.coeffs)
        batch, stride = plan.batch, plan.batch_stride
    win = t[tuple(slice(max(a - 1, 0), min(b + 1, n))
                  for (a, b), n in zip(ranges, t.shape))]
    nread = len(np.unique(np.concatenate(
        [win.ravel() + s * stride for s in range(batch)])))
    nwritten = len(plan.written_bricks())
    belems = int(np.prod(plan.bdims))
    return (4 * belems * (nin * nread + nout * nwritten),
            2 * ntaps * plan.fuse * nwritten * belems)
