"""The copy roofline and dependent-chain timing (port of
``bricklib_tpu/bench/roofline.py``).

- :func:`make_dma_copy` — a whole-storage copy by kernel K3
  (``csrc/brick_copy.cu``), the roofline every step rate is judged
  against (2 x itemsize bytes moved per element);
- :func:`barrier` — ``torch.cuda.synchronize`` where there is a card;
- :func:`chain` — a dependent chain ``out = fn(out)`` timed with CUDA
  events after one warm-up call.
"""

from __future__ import annotations

import time

import torch

from .. import _build


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


def chain(fn, x: torch.Tensor, it: int):
    """(avg seconds, last output) of ``it`` dependent calls after one
    warm-up call: CUDA events on a CUDA tensor, ``time.perf_counter`` on
    a CPU one."""
    out = fn(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(it):
            out = fn(out)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / it, out
    t0 = time.perf_counter()
    for _ in range(it):
        out = fn(out)
    return (time.perf_counter() - t0) / it, out
