"""Timing protocol of the reference (port of
``bricklib_tpu/bench/timing.py``: ``time_mpi`` and ``mpi_statistics``).

- ``time_mpi``: fixed MPI_ITER=25 iterations after one warm-up call
  (ref: stencils/fake.h:393-404, weak/main.cpp:39).  On a CUDA tensor
  the times come from CUDA events; on a CPU tensor from
  ``time.perf_counter``.
- ``mpi_statistics``: min/avg/max/sigma (ref: brick-mpi.h:758-793).
"""

from __future__ import annotations

import math
import time

import torch

MPI_ITER = 25


class _Clock:
    """Elapsed seconds between two marks, on the card's own clock where
    the work runs on a card."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return b - a


def _device_of(args) -> torch.device:
    for a in args:
        if torch.is_tensor(a):
            return a.device
    return torch.device("cpu")


def time_mpi(fn, *args, iters: int = MPI_ITER,
             chain: bool | None = None) -> tuple[float, list[float]]:
    """(avg seconds, per-iteration samples) after one warm-up call.

    When ``fn`` maps one tensor to one of the same shape and dtype, the
    average comes from a dependent chain ``out = fn(out)`` between two
    marks, and up to five single-call samples follow; otherwise every
    call on ``args`` is one sample."""
    clock = _Clock(_device_of(args))
    out0 = fn(*args)
    if clock.cuda:
        torch.cuda.synchronize()
    if chain is None:
        chain = (len(args) == 1 and torch.is_tensor(out0)
                 and out0.shape == args[0].shape
                 and out0.dtype == args[0].dtype)
    samples = []
    if chain:
        out = out0
        t0 = clock.mark()
        for _ in range(iters):
            out = fn(out)
        avg = clock.seconds(t0, clock.mark()) / iters
        for _ in range(min(iters, 5)):
            t0 = clock.mark()
            out = fn(out)
            samples.append(clock.seconds(t0, clock.mark()))
        return avg, samples
    for _ in range(iters):
        t0 = clock.mark()
        fn(*args)
        samples.append(clock.seconds(t0, clock.mark()))
    return sum(samples) / len(samples), samples


def mpi_statistics(samples) -> dict:
    """min/avg/max/sigma like the reference's pretty-printer
    (brick-mpi.h:758-793)."""
    n = len(samples)
    avg = sum(samples) / n
    var = sum((s - avg) ** 2 for s in samples) / n
    return {"min": min(samples), "avg": avg, "max": max(samples),
            "sigma": math.sqrt(var)}
