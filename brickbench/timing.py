"""Per-step times on the cards' own clocks.

The event arithmetic is a frozen copy of ``Clock`` in
``bricklib_tpu_torch/bench/timing.py``: a mark records one CUDA event on
each card's current stream, and an interval is read per card with
``elapsed_time``; across cards the longest of the cards' intervals is
the step's time.  Unlike ``Clock``, marks come from a pool made during
set-up (an event is created on its first record), and every interval of
a window is read once the window has closed.  On the CPU (the tests) a
mark is the host clock.
"""

from __future__ import annotations

import time

import torch


class StepClock:
    """Marks at step boundaries on ``devices``; ``seconds()`` gives the
    time of every interval between a mark and the next one that follows
    it as a step's end."""

    def __init__(self, devices, pool: int = 0):
        self.devices = [torch.device(d) for d in devices]
        self.cuda = all(d.type == "cuda" for d in self.devices)
        self._pool: list = []
        self._used: list = []
        self._pairs: list[tuple[int, int]] = []
        if self.cuda:
            self.grow(pool)

    def grow(self, n: int) -> None:
        """Make ``n`` more marks and record each once, so that the
        underlying events exist before a window starts."""
        for _ in range(n):
            evs = []
            for d in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                evs.append(ev)
            self._pool.append(evs)

    def mark(self) -> int:
        """Record a mark on every card; returns its index."""
        if not self.cuda:
            self._used.append(time.perf_counter())
            return len(self._used) - 1
        evs = self._pool.pop() if self._pool else None
        if evs is None:
            self.grow(1)
            evs = self._pool.pop()
        for d, ev in zip(self.devices, evs):
            ev.record(torch.cuda.current_stream(d))
        self._used.append(evs)
        return len(self._used) - 1

    def step(self, start: int, end: int) -> None:
        """Count the interval from mark ``start`` to mark ``end`` as one
        step."""
        self._pairs.append((start, end))

    def seconds(self) -> list[float]:
        """Every step's seconds, in order: on several cards the longest
        of the cards' intervals."""
        if not self.cuda:
            return [self._used[b] - self._used[a] for a, b in self._pairs]
        for ev in self._used[-1] if self._used else []:
            ev.synchronize()
        return [max(x.elapsed_time(y) for x, y in
                    zip(self._used[a], self._used[b])) / 1e3
                for a, b in self._pairs]

    def reset(self) -> None:
        """Forget the recorded steps; their marks go back to the pool."""
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)
            self._pool.extend(self._used)
        self._used, self._pairs = [], []
