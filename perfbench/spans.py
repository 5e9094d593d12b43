"""The program's spans, read in process: the port's span ring
(`ggrmcp_tpu_torch/utils/tracing.py::tracer`), which the co-launched
program fills in the harness's own process, and which outlives it.

A span here is a dict: name, trace (its call's trace id, "" for work of
no call), id, parent, start (wall seconds, the tick records' axis), ms
(its duration) and attrs. A selection is None when the ring dropped a
span that ends at or after its start: a reader never reports a partial
interval. A program without the ring's snapshot (an older one) gives no
spans, so its readers read nothing.
"""

from __future__ import annotations

import sys

from perfbench import records, traffic


def since(t0: float):
    """Every span starting at or after wall time `t0`, in the ring's
    order; None when spans of that stretch were dropped."""
    tracing = sys.modules.get("ggrmcp_tpu_torch.utils.tracing")
    snapshot = getattr(getattr(tracing, "tracer", None), "snapshot", None)
    if snapshot is None:
        return []
    kept, dropped_until = snapshot()
    if dropped_until >= t0:
        return None
    return [dict(name=s.name, trace=s.trace_id, id=s.span_id,
                 parent=s.parent_id, start=s.start_unix, ms=s.duration_ms,
                 attrs=s.attrs)
            for s in kept if s.start_unix >= t0]


def in_slice(run: dict, name: str):
    """The spans `name` that start inside the profiled slice (the region
    spans exist only there); None without a slice or when dropped."""
    trace = run.get("trace")
    if not trace:
        return None
    found = since(trace["t0"])
    if found is None:
        return None
    return [s for s in found if s["name"] == name and s["start"] < trace["t1"]]


def window_calls(run: dict, *names: str):
    """{trace id: {name: span}} of the calls due in the window, for the
    span names given; None when dropped."""
    found = since(run["w0"])
    if found is None:
        return None
    ids = {traffic.trace_id(run["seed"], c["index"])
           for c in records.due_in_window(run)}
    out: dict = {}
    for s in found:
        if s["trace"] in ids and s["name"] in names:
            out.setdefault(s["trace"], {})[s["name"]] = s
    return out


def window_turns(run: dict):
    """[(turn, its children)] of the serving-loop turns that start in
    the window; None when dropped."""
    found = since(run["w0"])
    if found is None:
        return None
    turns = {s["id"]: (s, []) for s in found if s["name"] == "batcher.turn"
             and s["start"] < run["w1"]}
    for s in found:
        if s["parent"] in turns:
            turns[s["parent"]][1].append(s)
    return list(turns.values())


# The serving loop's children of a turn; the rest of a turn is executor
# hops (the thread handoffs and the loop's wait to run its task again).
TURN_CHILDREN = ("batcher.yield", "batcher.host_ops", "batcher.admit",
                 "batcher.wait_work")
TURN_REST = "executor hop"
TICK_PHASES = ("sync", "dispatch", "wait", "host")


def named_intervals(run: dict, found: list) -> list:
    """[(start, end, name)] on the wall axis: each tick's phases, laid
    end to end from its `t_wall`, each loop turn (named by its
    remainder, `TURN_REST`) and each of its children."""
    out = []
    for t in run["ticks"]:
        mark = t["t_wall"]
        for phase in TICK_PHASES:
            end = mark + t[f"phase_{phase}_ms"] * 1e-3
            out.append((mark, end, f"tick {phase}"))
            mark = end
    for s in found:
        if s["name"] == "batcher.turn" or s["name"] in TURN_CHILDREN:
            name = TURN_REST if s["name"] == "batcher.turn" else s["name"]
            out.append((s["start"], s["start"] + s["ms"] * 1e-3, name))
    return out


def _innermost(t: float, intervals: list) -> str:
    inside = [(end - start, name) for start, end, name in intervals
              if start <= t < end]
    return min(inside)[1] if inside else "unnamed"


def idle_gaps(run: dict, min_s: float = 1e-3, step_s: float = 1e-4):
    """The profiled slice's device idle gaps of `min_s` or more, named
    by the innermost program span or tick phase on the wall axis:
    `idle_s` (their total), `named_share` (the share of it inside some
    named interval), `by_name` ({name: seconds}, each `step_s` of a gap
    named by its innermost interval) and `longest` ([name at its middle,
    ms] of the 10 longest). None without a slice, without kernels, or
    when the ring dropped spans of it."""
    trace = run.get("trace")
    if not trace:
        return None
    kernels = sorted((k for k in trace["kernels"] if k[1] is not None),
                     key=lambda k: k[1])
    found = since(trace["t0"] - 5)
    if not kernels or found is None:
        return None
    gaps, end = [], kernels[0][1] + kernels[0][2]
    for _, ts, dur in kernels[1:]:
        if ts - end >= min_s:
            gaps.append((end, ts))
        end = max(end, ts + dur)
    intervals = named_intervals(run, found)
    by_name: dict = {}
    for a, b in gaps:
        n = max(1, round((b - a) / step_s))
        for i in range(n):
            name = _innermost(a + (i + 0.5) * (b - a) / n, intervals)
            by_name[name] = by_name.get(name, 0.0) + (b - a) / n
    idle = sum(b - a for a, b in gaps)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return dict(
        idle_s=idle,
        named_share=(1 - by_name.get("unnamed", 0.0) / idle) if idle else None,
        by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        longest=[[_innermost((a + b) / 2, intervals), (b - a) * 1e3]
                 for a, b in longest])
