"""The traced slice: torch.profiler over a few calls after the measured
window, read back from its Chrome trace.

Each call runs inside a ``record_function`` span named ``portbench.call``;
the generators put further spans around the program's layers from outside
(``portbench.encode``). A kernel belongs to a span when the host call that
launched it (matched by the trace's correlation id) lies inside the span.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

from portbench import counts

CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Op:
    name: str
    family: str
    start: float        # device clock, seconds
    dur: float          # seconds
    launch: float       # host clock of the launching call, seconds (or -1)


@dataclass
class Trace:
    ops: list
    spans: dict                   # span name -> [(start, end)] seconds
    host_ops: list = field(default_factory=list)   # (start, end, name)
    calls: int = 0

    @property
    def window(self) -> tuple:
        calls = self.spans.get(CALL, [])
        return (min(s for s, _ in calls), max(e for _, e in calls))

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window,
        sorted."""
        lo, hi = self.window
        out = []
        for s, e in sorted((max(o.start, lo), min(o.start + o.dur, hi))
                           for o in self.ops):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def in_span(self, name: str, ops=None) -> list:
        """The operations launched inside a span called ``name``."""
        spans = sorted(self.spans.get(name, []))
        starts = [s for s, _ in spans]
        out = []
        for o in (self.ops if ops is None else ops):
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= spans[i][1]:
                out.append(o)
        return out

    def family_s(self, fam: str, ops=None) -> tuple:
        """(seconds, count) of the operations of one kernel family."""
        sel = [o for o in (self.ops if ops is None else ops)
               if o.family == fam]
        return sum(o.dur for o in sel), len(sel)

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the idle
        gaps inside the window summed by what the host was doing at their
        middle (the innermost host operation there)."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        lo, hi = self.window
        gaps, prev = {}, lo
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > prev:
                label = self._host_at((prev + s) / 2)
                gaps[label] = gaps.get(label, 0.0) + (s - prev)
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[_short(n), v] for n, v in ops],
                "idle_gaps": [[_short(n), v] for n, v in idle]}

    def _host_at(self, t: float) -> str:
        """The innermost host operation of the calling thread around t:
        of nested ones, the last to start."""
        if not hasattr(self, "_starts"):
            self.host_ops.sort()
            self._starts = [s for s, _, _ in self.host_ops]
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 500, -1), -1):
            s, e, name = self.host_ops[j]
            if s <= t <= e:
                return name
        return "host between operations"


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def parse(events: list) -> Trace:
    """A Trace from the Chrome trace's ``traceEvents`` (times in us)."""
    launches, spans, host_ops, raw = {}, {}, [], []
    caller = next((ev.get("tid") for ev in events
                   if ev.get("name") == CALL), None)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)) * 1e-6, \
            float(ev.get("dur", 0.0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            raw.append((ev.get("name", ""), ts, dur, corr))
        elif cat in LAUNCH_CATS:
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            spans.setdefault(ev.get("name", ""), []).append((ts, ts + dur))
            host_ops.append((ts, ts + dur, ev.get("name", "")))
        elif cat == "cpu_op" and ev.get("tid") == caller:
            host_ops.append((ts, ts + dur, ev.get("name", "")))
    ops = [Op(n, counts.family(n), ts, dur, launches.get(c, -1.0))
           for n, ts, dur, c in raw]
    return Trace(ops, spans, host_ops, len(spans.get(CALL, [])))


def capture(call, n_calls: int) -> Trace:
    """Profile ``n_calls`` calls of ``call(i)``, each inside a
    ``portbench.call`` span that ends once the device has finished it, and
    read the trace (written under TMPDIR and
    removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                           else [])
    with profile(activities=activities) as prof:
        for i in range(n_calls):
            with record_function(CALL):
                call(i)
                if card:
                    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        Path(path).unlink(missing_ok=True)
    return parse(events)
