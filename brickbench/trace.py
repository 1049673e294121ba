"""A short ``torch.profiler`` window over the loop, reduced to what the
per-layer metrics read.

The loop marks each step call and each refresh with
``record_function`` (:data:`STEP`, :data:`REFRESH`) and the whole
window with :data:`WINDOW`.  The profiler's Chrome trace is written
under ``TMPDIR``, read back and deleted.  Every device operation (a
kernel, a copy or a fill) is tied to the host call that launched it by
its correlation id, and through that call to the mark around it: the
operations of the program's steps are those launched inside a
:data:`STEP` mark.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW, STEP, REFRESH = "brickbench.window", "brickbench.step", \
    "brickbench.refresh"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    name: str
    device: int
    start: float  # microseconds, the trace's clock
    end: float
    owner: str  # the mark its launch lay in: STEP, REFRESH or ""


@dataclass
class TraceSummary:
    """The device's operations within the traced window, and the host's
    activity around them."""

    window_s: float
    steps: int
    devices: list
    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)  # (start, end, name) sorted

    def busy_s(self, device=None, owner=None) -> float:
        """Seconds in which an operation ran on ``device`` (default: on
        any card), counting only operations of ``owner`` if given."""
        ivs = sorted((o.start, o.end) for o in self.ops
                     if (device is None or o.device == device)
                     and (owner is None or o.owner == owner))
        return _union(ivs) / 1e6

    def busy_mean_s(self, owner=None) -> float:
        """:meth:`busy_s` averaged over the cards."""
        if not self.devices:
            return 0.0
        return sum(self.busy_s(d, owner) for d in self.devices) / len(
            self.devices)

    def op_seconds(self, match, owner=None) -> float:
        """Summed seconds of the operations whose name ``match`` accepts."""
        return sum(o.end - o.start for o in self.ops
                   if match(o.name) and (owner is None or o.owner == owner)
                   ) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """``[name, seconds]`` of the ``n`` operation names that took most
        device time, summed over the window and the cards."""
        by: dict = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> list:
        """``[name, seconds]``: the time in which no card ran anything,
        summed by what the host was doing at the middle of each gap (the
        mark around it, then the innermost host call), the ``n`` largest."""
        ivs = sorted((o.start, o.end) for o in self.ops)
        starts = [h[0] for h in self.host]
        by: dict = {}
        end = None
        for s, e in ivs:
            if end is not None and s > end:
                name = self._host_at((s + end) / 2, starts)
                by[name] = by.get(name, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def _host_at(self, t: float, starts) -> str:
        mark, inner = "", ""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and not (mark and inner):
            s, e, name = self.host[i]
            if e >= t:
                if name in (STEP, REFRESH, WINDOW):
                    mark = mark or name
                else:
                    inner = inner or name
            i -= 1
        return f"{mark or 'host'}: {inner or 'python'}"


def _union(ivs) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events: list) -> TraceSummary:
    """Reduce the Chrome trace's ``traceEvents`` to a :class:`TraceSummary`
    of the :data:`WINDOW` mark (the first one)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next((e for e in xs if e.get("name") == WINDOW
                and e.get("cat", "").lower() == "user_annotation"), None)
    if win is None:
        raise ValueError(f"the trace holds no {WINDOW} mark")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat", "").lower() == "user_annotation"
                   and e.get("name") in (STEP, REFRESH))
    mark_starts = [m[0] for m in marks]

    def owner_at(t: float) -> str:
        i = bisect.bisect_right(mark_starts, t) - 1
        return marks[i][2] if i >= 0 and marks[i][1] >= t else ""

    launches = {}
    for e in xs:
        if e.get("cat", "").lower() in LAUNCH_CATS:
            cid = e.get("args", {}).get("correlation")
            if cid is not None:
                launches[cid] = float(e["ts"])
    ops, devices = [], []
    for e in xs:
        if e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s0, e0 = max(s, w0), min(s + d, w1)
        if e0 <= s0:
            continue
        args = e.get("args", {})
        dev = int(args.get("device", e.get("pid", 0)))
        t_launch = launches.get(args.get("correlation"))
        owner = owner_at(t_launch) if t_launch is not None else ""
        ops.append(DeviceOp(e.get("name", "?"), dev, s0, e0, owner))
        if dev not in devices:
            devices.append(dev)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in xs
                  if e.get("cat", "").lower() in HOST_CATS
                  and float(e["ts"]) < w1 and
                  float(e["ts"]) + float(e["dur"]) > w0)
    steps = sum(1 for m in marks if m[2] == STEP and w0 <= m[0] <= w1)
    return TraceSummary((w1 - w0) / 1e6, steps, sorted(devices), ops, host)


def profile(fn, cuda: bool) -> TraceSummary:
    """Run ``fn()`` under ``torch.profiler`` inside a :data:`WINDOW` mark
    (``fn`` waits for the cards before it returns) and summarize the
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events)
