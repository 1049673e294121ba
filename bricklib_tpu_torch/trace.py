"""The program's spans and counters: the port's one tracing system.

Spans mark the layer boundaries of a step:

- ``bricklib.step``: a step of the weak or the strong driver (``step``:
  its ordinal, the request id every span inside it carries);
- ``bricklib.exchange``: every ghost exchange, at the entry of the callable
  :func:`~.comm.exchange.mesh_fn` makes (SHIFT, PUT, shift-remote and the
  strong exchanges);
- ``bricklib.sweep``: the callable each sweep planner returns (K1, K4, K6,
  K7, K8, K12; K11, exchange and sweep at once, with ``exchange="fused"``),
  its arguments made once per plan by :func:`sweep_args` (K1's and K4's
  also name their ``body``, ``stream`` or ``regstream``, and K1's its
  table's ``layout``, ``pencil`` or ``ibrick``);
- ``bricklib.plan``: the weak or the strong driver's set-up, with the
  children ``bricklib.plan.decomp`` (the decomposition and its tables),
  ``bricklib.plan.domain`` (the host draw of the domain, bricked, and the
  state on the cards) and ``bricklib.plan.kernels`` (the sweeps' plans,
  made on a step's first call for its batch of ranks).

Tracing is off by default: :func:`span` then returns one shared no-op
object and records and allocates nothing (the caller passes arguments made
beforehand, never a fresh ``**kwargs`` dict).  On (:func:`enable`,
:func:`tracing`), each span keeps a :class:`Span` in memory and opens a
``torch.profiler.record_function`` range: under a profiler the span then
lies in the trace on the device trace's own clock, and every device
operation launched inside it is tied to it by correlation id.  The spans
of one process nest as one stack: trace from one thread.  :func:`records`
takes them.

Counters are plain ints, always on: each kernel's launches (the
``launches`` attribute of its wrapper, read where it is), those of K1's
register-streaming body (``k1_regstream``) and of K1 on an i-bricked
table (``k1_ibrick``: ``pencil_sweep_kernel.ibrick_launches``), each a K1
launch too, those of K1's register-streaming body on an i-bricked table
that store every output quad of rows from one row offset
(``k1_ibrick_quads``: ``pencil_sweep_kernel.quad_launches``), each also a
``k1_ibrick`` and a ``k1_regstream`` launch, those of K4's
register-streaming body (``k4_regstream``), each a K4 launch too, the
``Tensor.copy_`` calls between ranks (``rank_copies``) and the ghost bytes
the exchanges write (``exchange_bytes``, each byte of the payload once).
:func:`counters` returns a snapshot.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from dataclasses import dataclass

import torch

STEP, EXCHANGE, SWEEP = "bricklib.step", "bricklib.exchange", \
    "bricklib.sweep"
PLAN = "bricklib.plan"
PLAN_DECOMP, PLAN_DOMAIN, PLAN_KERNELS = (PLAN + ".decomp", PLAN + ".domain",
                                          PLAN + ".kernels")

# the launch counters: kernel -> (module, wrapper whose ``launches`` counts)
KERNELS = {
    "K1": ("codegen.pencil_kernel", "pencil_sweep_kernel"),
    "K2": ("comm.exchange", "copy_intervals"),
    "K3": ("bench.roofline", "copy_storage"),
    "K4": ("codegen.pencil_kernel_4d", "pencil_sweep_4d_kernel"),
    "K5": ("comm.strong", "stage_copy"),
    "K6": ("codegen.pencil_kernel_2d", "pencil_sweep_2d_kernel"),
    "K7": ("codegen.dense_kernel", "dense_stencil_kernel"),
    "K8": ("codegen.mxu_kernel", "pencil_sweep_mxu_kernel"),
    "K9": ("comm.exchange", "remote_copy"),
    "K10": ("comm.strong", "strong_remote_copy"),
    "K11": ("codegen.fused_exchange", "pencil_sweep_fusedx_kernel"),
    "K12": ("codegen.pencil_kernel_nd", "pencil_sweep_nd_kernel"),
}
# the launches of a kernel's second body or layout, each one of its
# kernel's too: name -> (module, wrapper, the wrapper's attribute that
# counts); no name starts with "K", so a sum over the kernels' counters
# counts each launch once
BODIES = {
    "k1_regstream": ("codegen.pencil_kernel", "launch_regstream",
                     "launches"),
    "k1_ibrick": ("codegen.pencil_kernel", "pencil_sweep_kernel",
                  "ibrick_launches"),
    "k1_ibrick_quads": ("codegen.pencil_kernel", "pencil_sweep_kernel",
                        "quad_launches"),
    "k4_regstream": ("codegen.pencil_kernel_4d", "launch_regstream_4d",
                     "launches"),
}

_on = False
_open: list = []      # the open spans, innermost last
_done: list = []      # every span opened since the last records()
_next_id = 0
_counts = {"rank_copies": 0, "exchange_bytes": 0}


@dataclass
class Span:
    """One span: ``id`` and its ``parent``'s (None at the top), the
    ordinal of the step it belongs to (None outside a step), start and
    end on ``time.perf_counter_ns()`` (end None while open) and its
    arguments."""

    id: int
    name: str
    parent: int | None
    step: int | None
    start_ns: int
    end_ns: int | None = None
    args: dict | None = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Null:
    """The span of tracing off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Open:
    """A span being traced: its record, and its profiler range."""

    __slots__ = ("rec", "range")

    def __init__(self, name, args, step):
        global _next_id
        parent = _open[-1] if _open else None
        if parent is not None and step is None:
            step = parent.step
        self.rec = Span(_next_id, name, parent.id if parent else None, step,
                        0, args=args)
        _next_id += 1
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        _open.append(self.rec)
        _done.append(self.rec)
        self.rec.start_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.perf_counter_ns()
        _open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, args: dict | None = None, step: int | None = None):
    """The context manager of one span ``name``: shared no-op while
    tracing is off; on, a record (``args`` as given, not copied; ``step``
    the step's ordinal, else the enclosing span's) and a profiler range."""
    if not _on:
        return NULL
    return _Open(name, args, step)


def sweep_args(kernel: str, fuse: int = 1, ranges=(), **more) -> dict:
    """A ``bricklib.sweep`` span's arguments, made once per plan: the
    kernel, the fused depth and whether the sweep writes into the ghost
    ring (``ghost``: a range of the table starts at its edge) or only the
    owned bricks (``owned``)."""
    ghost = any(int(r[0]) == 0 for r in ranges)
    return dict(kernel=kernel, fuse=int(fuse),
                region="ghost" if ghost else "owned", **more)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block, then as it was before."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def records() -> list[Span]:
    """Every span opened since the last call, in the order they opened
    (an open span's ``end_ns`` is None); the list starts anew."""
    global _done
    out, _done = _done, []
    return out


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (``rank_copies``,
    ``exchange_bytes``)."""
    _counts[name] += n


def counters() -> dict:
    """A snapshot: each kernel's launches (``K1`` to ``K12``) and its
    second bodies' (:data:`BODIES`), read from their wrappers, with
    ``rank_copies`` and ``exchange_bytes``."""
    out = {}
    for k, (mod, fn, *attr) in {**KERNELS, **BODIES}.items():
        w = getattr(importlib.import_module(f"{__package__}.{mod}"), fn)
        out[k] = int(getattr(w, attr[0] if attr else "launches"))
    out.update(_counts)
    return out


def span_times(events) -> dict:
    """``{span name: [count, host ms, device ms]}`` of the program's spans
    in a Chrome trace's ``traceEvents`` (``torch.profiler``'s export):
    host ms the spans' own durations, device ms every kernel, copy or
    fill under the innermost span open when the host launched it (tied by
    correlation id); operations launched outside every span fall under
    ``""``."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat", "").lower() == "user_annotation"
                   and e.get("name", "").startswith("bricklib."))
    starts = [sp[0] for sp in spans]
    out: dict = {}
    for s0, s1, name in spans:
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s1 - s0) / 1e3
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat", "").lower() in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for e in xs:
        if e.get("cat", "").lower() not in ("kernel", "gpu_memcpy",
                                            "gpu_memset"):
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        name = "" if t is None else innermost(spans, starts, t)
        out.setdefault(name, [0, 0.0, 0.0])[2] += float(e.get("dur", 0)) / 1e3
    return out


def innermost(spans, starts, t: float) -> str:
    """The name of the innermost of ``spans`` (``(start, end, name)``
    sorted, properly nested; ``starts`` their starts) open at ``t``, or
    ``""``: walking back from the last span begun by ``t``, the first
    still open."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][1] >= t:
            return spans[i][2]
        i -= 1
    return ""
