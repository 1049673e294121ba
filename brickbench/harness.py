"""One run of a cell: build the program's step, warm up, drive the closed
loop for the window, read the metrics, then check the window's answers
against the plain reference.

The traffic is a closed loop of *runs*: each run starts the state from a
fresh field (one of ``fields`` drawn from the seed, in turn) and then
takes ``problem_steps`` steps, each reading the previous step's output,
as an iterated stencil does.  A run's final state is its answer.  A
reservoir sample of ``checked`` answers, drawn from the seed, is kept
during the window and compared after it with the reference's
``problem_steps * st_iter`` iterations of the same field.
"""

from __future__ import annotations

import gc
import os
import random
import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from . import fields, reference, roofline, trace
from .cell import Cell
from .timing import StepClock


class System:
    """The program under test: ``bricklib_tpu_torch.drivers.weak``'s
    step on the cell's shapes (pencil backend, SHIFT exchange, real ghost
    bricks on every exchanged axis), one rank a card (on the CPU every
    rank on the CPU, the kernels' plain versions)."""

    def __init__(self, cell: Cell, device: str = "cuda"):
        from bricklib_tpu_torch.drivers.weak import build_step

        cfg = cell.config
        t0 = time.perf_counter()
        self.step, state, self.dec = build_step(
            dims=cell.domain, bdim=cell.brick, stencil=cfg["stencil"],
            st_iter=int(cfg["st_iter"]), fuse=int(cell.traffic["fuse"]),
            table_periodic=False, skin=cfg["skin"], device=device,
            mesh_shape=cell.mesh, exchange="shift", devices=None,
            backend="pencil")
        self.plan_s = time.perf_counter() - t0
        self.state = state
        self.cell = cell
        self.single = torch.is_tensor(state)
        cards = self.cards(state)
        self.devices = [t.device for t in cards]
        self.nbricks = int(cards[0].shape[1])
        bricks = tuple(cards[0].shape[2:])
        if bricks != cell.brick:
            raise ValueError(f"the program's bricks {bricks} are not the "
                             f"cell's {cell.brick}")
        gz = [g // b for g, b in zip(cell.ghost, cell.brick)]
        rows = fields.owned_rows(self.dec.grid, gz, self.nbricks)
        self.rows = {d: torch.from_numpy(rows).to(d) for d in self.devices}
        # (card, slot) of each rank in ravel order: the cards in order,
        # each holding its ranks in order
        self.places = [(c, s) for c, t in enumerate(cards)
                       for s in range(t.shape[0])]
        if len(self.places) != cell.ranks:
            raise ValueError(f"{len(self.places)} ranks in the state, the "
                             f"mesh has {cell.ranks}")

    def cards(self, x) -> list:
        """Per card, the ``[ranks, nbricks, *brick]`` tensor of state
        ``x``."""
        return [x.unsqueeze(0)] if self.single else list(x)

    def storage(self, field_: torch.Tensor) -> list:
        """The state (per card) that holds the global ``field_``: each
        rank's owned bricks, zero ghosts."""
        out = []
        for c, dev in enumerate(self.devices):
            ranks = [r for r, (cc, _s) in enumerate(self.places) if cc == c]
            out.append(torch.stack([fields.to_storage(
                fields.rank_block(field_, np.unravel_index(r, self.cell.mesh),
                                  self.cell.domain).to(dev),
                self.rows[dev], self.cell.brick, self.nbricks)
                for r in ranks]))
        return out

    def block(self, cards: list, rank: int) -> torch.Tensor:
        """Rank ``rank``'s dense owned block from per-card storage."""
        c, s = self.places[rank]
        return fields.from_storage(cards[c][s], self.rows[self.devices[c]],
                                   self.cell.brick, self.cell.domain)

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


class Loop:
    """The closed loop of runs over ``system``'s step (module docstring)."""

    def __init__(self, system: System, seed: int, clock: StepClock):
        t = system.cell.traffic
        self.sys, self.seed, self.clock = system, seed, clock
        self.R, self.P, self.S = (int(t["problem_steps"]), int(t["fields"]),
                                  int(t["checked"]))
        self.pool = [system.storage(fields.draw_field(
            system.cell.global_domain, seed, p, system.devices[0]))
            for p in range(self.P)]
        self.keep = [[torch.empty_like(c) for c in self.pool[0]]
                     for _ in range(self.S)]
        self.x = system.state
        self.reset()

    def reset(self) -> None:
        """Start counting anew: steps, runs begun and answers."""
        self.steps = self.begun = self.done = 0
        self.kept: list = [None] * self.S  # the field of each kept answer
        self.rng = random.Random(fields.sub_seed(self.seed, "sample"))

    def _refresh(self, p: int) -> None:
        for t, src in zip(self.sys.cards(self.x), self.pool[p]):
            t.copy_(src)

    def _keep(self) -> None:
        """Reservoir-sample the answer just finished."""
        n = self.done
        slot = n if n < self.S else self.rng.randrange(n + 1)
        if slot < self.S:
            for dst, src in zip(self.keep[slot], self.sys.cards(self.x)):
                dst.copy_(src)
            self.kept[slot] = (self.begun - 1) % self.P
        self.done += 1

    def run(self, deadline: float | None = None, steps: int | None = None,
            sample: bool = True, annotate: bool = False) -> None:
        """Whole runs until ``steps`` steps are done, or until the host
        clock has passed ``deadline`` when a run ends."""
        step, clock, R = self.sys.step, self.clock, self.R
        mark = (lambda name: torch.profiler.record_function(name)) \
            if annotate else (lambda name: nullcontext())
        target = None if steps is None else self.steps + steps
        while True:
            with mark(trace.REFRESH):
                self._refresh(self.begun % self.P)
            self.begun += 1
            start = clock.mark()
            for _ in range(R):
                with mark(trace.STEP):
                    self.x = step(self.x)
                end = clock.mark()
                clock.step(start, end)
                start = end
                self.steps += 1
            if sample:
                self._keep()
            if target is not None and self.steps >= target:
                return
            if deadline is not None and time.perf_counter() >= deadline:
                return

    def host_times(self, batches: int) -> list[float]:
        """Host seconds of each step call (the enqueue, no wait), over
        ``batches`` runs each started on idle cards."""
        out = []
        for _ in range(batches):
            self._refresh(self.begun % self.P)
            self.begun += 1
            self.sys.sync()
            for _ in range(self.R):
                t0 = time.perf_counter()
                self.x = self.sys.step(self.x)
                out.append(time.perf_counter() - t0)
        self.sys.sync()
        return out


@dataclass
class Record:
    """What one run measured: the metric readers' input."""

    cell: Cell
    setup_s: float
    plan_s: float
    window_s: float
    steps: int
    step_s: list
    answers: int
    bound_s: float  # one card's step, by the shapes
    host_step_s: list | None = None
    trace: trace.TraceSummary | None = None
    memory_peak_bytes: int = 0


def process_age() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields_ = f.read().rsplit(")", 1)[1].split()
        start = int(fields_[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def bound_s(cell: Cell) -> float:
    """One card's least step time by the cell's shapes (its ranks)."""
    nbytes, flops = roofline.step_work(cell.domain, cell.ghost,
                                       len(cell.taps),
                                       int(cell.config["st_iter"]))
    per_card = cell.ranks / max(cell.chips, 1)
    return roofline.bound(nbytes * per_card, flops * per_card)[0]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_begin: float | None = None,
             wrap=None, log=print) -> tuple[Record, dict]:
    """Run ``cell``: set-up, the measured window and (``traced``) the
    host stretch and the profiler window; then free the program's state
    and check the kept answers.  ``wrap(system)`` may replace
    ``system.step`` (the tests' faults).  Returns the record and the
    check (:func:`check`)."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    system = System(cell, device)
    if wrap is not None:
        wrap(system)
    cuda = all(d.type == "cuda" for d in system.devices)
    clock = StepClock(system.devices)
    loop = Loop(system, seed, clock)
    # warm-up: every operation the window runs, twice over; then one run
    # timed, to make the window's CUDA events beforehand
    loop.run(steps=2 * loop.R)
    system.sync()
    t0 = time.perf_counter()
    loop.run(steps=loop.R)
    system.sync()
    t_step = (time.perf_counter() - t0) / loop.R
    clock.reset()
    if cuda:
        clock.grow(int(2 * seconds / max(t_step, 1e-6)) + 256)
    loop.reset()
    gc.collect()
    gc.freeze()
    system.sync()

    setup_s = time.perf_counter() - t_begin
    t0 = time.perf_counter()
    loop.run(deadline=t0 + seconds)
    system.sync()
    window_s = time.perf_counter() - t0
    steps, answers = loop.steps, loop.done
    step_s = clock.seconds()
    log(f"window: {steps} steps, {answers} answers, {window_s:.6f} s")
    rec = Record(cell, setup_s, system.plan_s, window_s, steps, step_s,
                 answers, bound_s(cell))
    if traced:
        rec.host_step_s = loop.host_times(int(cell.traffic["host_batches"]))
        n = int(cell.traffic["trace_steps"])

        def traced_loop():
            loop.run(steps=n, sample=False, annotate=True)
            system.sync()

        rec.trace = trace.profile(traced_loop, cuda)
    rec.memory_peak_bytes = max(
        (torch.cuda.max_memory_allocated(d) for d in system.devices
         if d.type == "cuda"), default=0)
    gc.unfreeze()
    # free the program's state before the reference runs
    kept, keep = loop.kept, loop.keep
    del loop, clock
    system.state = system.step = None
    result = check(system, keep, kept, seed)
    return rec, result


def check(system: System, keep: list, kept: list, seed: int) -> dict:
    """Compare every kept answer with the reference: ``rel_err`` (the
    worst relative gap over the answers and ranks, and its limit),
    ``answers`` compared, ``failed`` over the limit, and ``ok``."""
    cell = system.cell
    iters = int(cell.traffic["problem_steps"]) * int(cell.config["st_iter"])
    limit = float(cell.traffic["limit_rel_err"])
    errs = []
    for slot, p in enumerate(kept):
        if p is None:
            continue
        want = reference.iterate(fields.draw_field(
            cell.global_domain, seed, p, system.devices[0]), cell.taps, iters)
        err = 0.0
        for r in range(cell.ranks):
            got = system.block(keep[slot], r).to(want.device)
            exp = fields.rank_block(want, np.unravel_index(r, cell.mesh),
                                    cell.domain)
            err = max(err, reference.rel_err(got, exp))
            del got
        del want
        errs.append(err)
    worst = max(errs, default=float("inf"))
    failed = sum(1 for e in errs if not e <= limit)
    return {"ok": bool(errs) and failed == 0, "answers": len(errs),
            "failed": failed, "rel_err": (worst, limit)}
