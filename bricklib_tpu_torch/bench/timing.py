"""Timing protocol of the reference (port of
``bricklib_tpu/bench/timing.py``: ``time_mpi`` and ``mpi_statistics``).

- ``time_mpi``: fixed MPI_ITER=25 iterations after one warm-up call
  (ref: stencils/fake.h:393-404, weak/main.cpp:39), over a tensor or a
  mesh state (one tensor per card).  On CUDA tensors the times come from
  CUDA events (:class:`Clock`: across cards, from the first card's start
  to the last card's end); on CPU tensors from ``time.perf_counter``.
- ``mpi_statistics``: min/avg/max/sigma (ref: brick-mpi.h:758-793).
"""

from __future__ import annotations

import math
import time

import torch

MPI_ITER = 25


def devices_of(args) -> list[torch.device]:
    """The devices of the tensors in ``args``, lists of tensors (a mesh
    state) included, in order of first appearance."""
    out: list[torch.device] = []
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else [a]):
            if torch.is_tensor(t) and t.device not in out:
                out.append(t.device)
    return out or [torch.device("cpu")]


class Clock:
    """Elapsed seconds between two marks, on the cards' own clocks where
    the work runs on cards.

    On several cards a mark records one event on each card's current
    stream.  :meth:`start` first waits for every card, so each card's
    start event is recorded on an idle stream and all starts fall within
    the host's time to record them; :meth:`seconds` waits for every end
    event and returns the longest start-to-end of any card, the span from
    the first card's start to the last card's end (CUDA cannot compare
    events of two cards directly)."""

    def __init__(self, devices):
        self.devices = [d for d in devices if d.type == "cuda"]
        self.cuda = bool(self.devices)

    def start(self):
        if self.cuda and len(self.devices) > 1:
            for d in self.devices:
                torch.cuda.synchronize(d)
        return self.mark()

    def mark(self):
        if self.cuda:
            evs = []
            for d in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                evs.append(ev)
            return evs
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            for ev in b:
                ev.synchronize()
            return max(x.elapsed_time(y) for x, y in zip(a, b)) / 1e3
        return b - a


def _same_form(out, arg) -> bool:
    """Whether ``out`` can be fed back as ``arg``: a tensor, or a list of
    tensors, of the same shapes and dtypes."""
    if torch.is_tensor(arg):
        return (torch.is_tensor(out) and out.shape == arg.shape
                and out.dtype == arg.dtype)
    return (isinstance(arg, (list, tuple)) and isinstance(out, (list, tuple))
            and len(out) == len(arg)
            and all(_same_form(o, x) for o, x in zip(out, arg)))


def time_mpi(fn, *args, iters: int = MPI_ITER,
             chain: bool | None = None) -> tuple[float, list[float]]:
    """(avg seconds, per-iteration samples) after one warm-up call.

    When ``fn`` maps its one argument (a tensor, or a mesh state: a list
    of tensors on one or more cards) to one of the same form, the average
    comes from a dependent chain ``out = fn(out)`` between two marks, and
    up to five single-call samples follow; otherwise every call on
    ``args`` is one sample.  Times come from CUDA events where the
    arguments lie on cards (:class:`Clock`)."""
    clock = Clock(devices_of(args))
    out0 = fn(*args)
    if clock.cuda:
        torch.cuda.synchronize()
    if chain is None:
        chain = len(args) == 1 and _same_form(out0, args[0])
    samples = []
    if chain:
        out = out0
        t0 = clock.start()
        for _ in range(iters):
            out = fn(out)
        avg = clock.seconds(t0, clock.mark()) / iters
        for _ in range(min(iters, 5)):
            t0 = clock.start()
            out = fn(out)
            samples.append(clock.seconds(t0, clock.mark()))
        return avg, samples
    for _ in range(iters):
        t0 = clock.start()
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
