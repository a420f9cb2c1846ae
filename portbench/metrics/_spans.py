"""Readers of the program's own spans (``frankenstein_tpu_torch/utils/
profiling.py:span``: ``predict.*``, ``decode.*``, ``train.*``,
``loader.wait``), which land in the traced slice's Chrome trace as
``record_function`` annotations on the profiler's clock. Each reads one
quantity a traced call (``trace.calls``: a request, or an optimizer step),
in ms, and returns None where the trace has no span of that name (a
program that opens none, or no trace)."""

from __future__ import annotations


def _spans(ctx: dict, name: str):
    """(trace, the union of the spans called ``name``, sorted), or None."""
    trace = ctx.get("trace")
    if trace is None or not trace.spans.get(name):
        return None
    out = []
    for s, e in sorted(trace.spans[name]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return trace, out


def idle_ms(ctx: dict, name: str):
    """Time a call inside the spans called ``name`` in which no device
    operation ran: the spans' intervals less ``trace.busy_intervals()``."""
    got = _spans(ctx, name)
    if got is None:
        return None
    trace, spans = got
    busy, j, idle = trace.busy_intervals(), 0, 0.0
    for lo, hi in spans:
        while j < len(busy) and busy[j][1] <= lo:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < hi:
            covered += min(hi, busy[k][1]) - max(lo, busy[k][0])
            k += 1
        idle += (hi - lo) - covered
    return 1e3 * idle / trace.calls


def device_ms(ctx: dict, name: str):
    """Device time a call of the operations launched inside the spans
    called ``name`` (``trace.in_span``: the launching host call lies inside
    one)."""
    got = _spans(ctx, name)
    if got is None:
        return None
    trace = got[0]
    return 1e3 * sum(o.dur for o in trace.in_span(name)) / trace.calls


def host_ms(ctx: dict, name: str):
    """Host time a call inside the spans called ``name``: the length of
    their union."""
    got = _spans(ctx, name)
    if got is None:
        return None
    trace, spans = got
    return 1e3 * sum(e - s for s, e in spans) / trace.calls
