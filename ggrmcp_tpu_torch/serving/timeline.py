"""Unified diagnostic timeline: one Chrome trace-event JSON document
merging the stack's three existing rings — gateway spans
(utils/tracing.py), engine tick records, and request lifecycle records
(serving/flight_recorder.py) — loadable straight into Perfetto
(ui.perfetto.dev) or chrome://tracing. Served by the gateway at
`GET /debug/timeline` on both HTTP implementations.

Layout: the gateway is one process row (pid 1) with one thread per
trace id, so concurrent calls never overlap on a track; spans of no call
(the co-launched batcher's turns and admissions, its device regions)
sit on the first backend's "<family> spans" threads; each backend is
its own process row with one "ticks" thread per source batcher (flat
pool / KV tier), one row per request lifecycle, and instant markers for
lifecycle events (shed / replay / queue timeout, derived from the
cumulative counters snapshotted in consecutive tick records, plus
terminal request failures — a chaos run's injected failpoints surface
here). Tick slices nest their phase attribution (admit / sync /
dispatch / wait / host — the PhaseTimer partition of duration_ms) as
child slices, so "where did this tick's budget go" is visible at a
glance.

Clock alignment: every tick record carries a PAIRED wall/mono stamp
taken at dispatch (t_wall, t_mono). All durations on the sidecar side
are monotonic-derived (the PhaseTimer), and each record's wall stamp
anchors them on the shared wall-clock axis; gateway spans and request
records already carry wall stamps (span.start_unix,
RequestRecord.t_submit). One wall axis therefore spans gateway and
sidecar without assuming their monotonic clocks share an epoch.

This module is deliberately stdlib-only (no jax, no aiohttp): the
gateway imports it without pulling the model plane in.
"""

from __future__ import annotations

from typing import Any, Optional

# Tick phases in wall-clock order within a tick; mirrored from
# serving/flight_recorder.py::PHASE_NAMES (kept literal here so the
# gateway does not import the recorder — protojson keys are the
# contract between the two processes).
_PHASES = ("admit", "sync", "dispatch", "wait", "host")

# Lifecycle counters whose per-tick deltas become instant events.
_LIFECYCLE = (
    ("shedTotal", "shed"),
    ("replayedTotal", "replay"),
    ("timedOutTotal", "queue-timeout"),
)

# finish_reasons that mark a request row with a failure instant.
_FAILURE_REASONS = {"timeout", "cancelled", "error", "overloaded"}

_PID_GATEWAY = 1
# The first "<family> spans" thread of a backend's row: past its tick
# sources, before its compile (999) and request (1000+) rows.
_TID_BATCHER = 900


def _f(value: Any, default: float = 0.0) -> float:
    """protojson-tolerant float: int64 fields arrive as strings, zero
    scalars are omitted entirely."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _us(seconds: float) -> int:
    return int(round(seconds * 1e6))


def _meta(pid: int, tid: int, kind: str, name: str) -> dict:
    return {
        "ph": "M", "name": kind, "pid": pid, "tid": tid, "ts": 0,
        "args": {"name": name},
    }


def _span_events(spans: list, events: list, batcher_pid: int) -> None:
    """Gateway spans → complete ("X") slices, one thread per trace id
    (concurrent calls must not overlap on one track; spans of the same
    trace nest by containment). A span of no call (empty trace id) goes
    to `batcher_pid`'s thread of its family (the name's first part)."""
    tids: dict[str, int] = {}
    families: dict[str, int] = {}
    for span in sorted(spans, key=lambda s: _f(s.get("startUnix"))):
        name = str(span.get("name", "span"))
        trace_id = str(span.get("traceId", ""))
        pid = _PID_GATEWAY
        if not trace_id:
            family = name.split(".")[0]
            pid, tid = batcher_pid, families.get(family)
            if tid is None:
                tid = families[family] = _TID_BATCHER + len(families)
                events.append(_meta(pid, tid, "thread_name",
                                    f"{family} spans"))
            trace_id = "-"
        else:
            tid = tids.get(trace_id)
        if tid is None:
            tid = tids[trace_id] = len(tids) + 1
            events.append(_meta(
                _PID_GATEWAY, tid, "thread_name", f"trace {trace_id[:8]}"
            ))
        events.append({
            "ph": "X", "cat": "span",
            "name": name,
            "ts": _us(_f(span.get("startUnix"))),
            "dur": _us(_f(span.get("durationMs")) / 1000.0),
            "pid": pid, "tid": tid,
            "args": {
                "traceId": trace_id,
                "spanId": span.get("spanId", ""),
                "parentId": span.get("parentId", ""),
                **(span.get("attrs") or {}),
            },
        })


def _tick_events(ticks: list, pid: int, events: list) -> None:
    """Tick records → one "ticks <source>" thread per source batcher:
    a parent slice per tick with its phase partition nested as child
    slices, lifecycle-counter deltas as instant markers, and counter
    ("C") tracks for the paged-arena occupancy and the device-memory
    ledger's per-component bytes — HBM pressure on the same time axis
    as the phases (Perfetto renders each counter name as its own
    track; the multi-series memory counter stacks its components)."""
    tids: dict[str, int] = {}
    prev: dict[str, dict] = {}  # source -> previous record's counters
    for tick in sorted(ticks, key=lambda t: _f(t.get("tWall"))):
        source = str(tick.get("source", ""))
        tid = tids.get(source)
        if tid is None:
            tid = tids[source] = len(tids) + 1
            events.append(_meta(
                pid, tid, "thread_name", f"ticks {source or 'pool'}"
            ))
        phases = {p: _f(tick.get(f"phase{p.title()}Ms")) for p in _PHASES}
        duration_ms = _f(tick.get("durationMs"))
        # t_wall is stamped at dispatch — the admit phase precedes it,
        # so the attributed tick window opens admit_ms earlier.
        start_us = _us(_f(tick.get("tWall")) - phases["admit"] / 1000.0)
        args = {
            k: tick.get(k)
            for k in (
                "seq", "activeSlots", "admitted", "finished",
                "interleavedRows", "traceIds", "specDrafted",
                "specAccepted", "kvPagesInUse",
            )
            if k in tick
        }
        events.append({
            "ph": "X", "cat": "tick",
            "name": f"tick {tick.get('seq', '?')}",
            "ts": start_us, "dur": _us(duration_ms / 1000.0),
            "pid": pid, "tid": tid, "args": args,
        })
        cursor = start_us
        for phase in _PHASES:
            dur_us = _us(phases[phase] / 1000.0)
            if dur_us > 0:
                events.append({
                    "ph": "X", "cat": "tick.phase", "name": phase,
                    "ts": cursor, "dur": dur_us, "pid": pid, "tid": tid,
                    "args": {"ms": round(phases[phase], 3)},
                })
            cursor += dur_us
        last = prev.setdefault(source, {})
        for key, label in _LIFECYCLE:
            value = _f(tick.get(key))
            if value > last.get(key, 0.0):
                events.append({
                    "ph": "i", "cat": "lifecycle", "name": label,
                    "ts": _us(_f(tick.get("tWall"))), "s": "t",
                    "pid": pid, "tid": tid,
                    "args": {"delta": value - last.get(key, 0.0)},
                })
            last[key] = value
        ts_wall = _us(_f(tick.get("tWall")))
        if "kvPagesInUse" in tick:
            events.append({
                "ph": "C", "cat": "memory",
                "name": f"kv_pages_in_use {source or 'pool'}",
                "ts": ts_wall, "pid": pid, "tid": tid,
                "args": {"pages": _f(tick.get("kvPagesInUse"))},
            })
        comps = tick.get("memoryComponents") or []
        if comps:
            # One multi-series counter event: Perfetto stacks the
            # components, so the track reads like the ledger's
            # partition of HBM at this tick (int64 bytes arrive as
            # protojson strings — _f both).
            values = tick.get("memoryComponentBytes") or []
            events.append({
                "ph": "C", "cat": "memory",
                "name": f"memory_bytes {source or 'pool'}",
                "ts": ts_wall, "pid": pid, "tid": tid,
                "args": {
                    str(c): _f(v) for c, v in zip(comps, values)
                },
            })


def _compile_events(compiles: list, pid: int, events: list) -> None:
    """Compile-watcher ring → one "compiles" thread per sidecar: an
    instant per XLA compile (name = the compiled program), so "that
    slow tick was a recompile" reads straight off the timeline.
    Post-warmup recompiles — the steady-state perf killer — are
    flagged in args and use global scope so Perfetto draws them
    full-height."""
    if not compiles:
        return
    tid = 999  # below the request rows (1000+), above the tick tracks
    events.append(_meta(pid, tid, "thread_name", "compiles"))
    for rec in sorted(compiles, key=lambda c: _f(c.get("tWall"))):
        post = bool(rec.get("postWarmup", False))
        events.append({
            "ph": "i", "cat": "compile",
            "name": str(rec.get("fnName", "compile")),
            "ts": _us(_f(rec.get("tWall"))),
            "s": "g" if post else "t",
            "pid": pid, "tid": tid,
            "args": {
                "durationMs": _f(rec.get("durationMs")),
                "postWarmup": post,
            },
        })


def _request_events(requests: list, pid: int, events: list) -> None:
    """Request records → one row per lifecycle, linked to the ticks it
    rode via firstTick/lastTick/traceId in args; terminal failures get
    an instant marker at the row's end."""
    base_tid = 1000  # past any plausible tick-source tid
    for k, req in enumerate(
        sorted(requests, key=lambda r: _f(r.get("tSubmit")))
    ):
        tid = base_tid + k
        trace_id = str(req.get("traceId", "")) or "-"
        reason = str(req.get("finishReason", ""))
        events.append(_meta(
            pid, tid, "thread_name", f"req {trace_id[:8]}"
        ))
        start_us = _us(_f(req.get("tSubmit")))
        dur_us = _us(_f(req.get("e2eMs")) / 1000.0)
        events.append({
            "ph": "X", "cat": "request",
            "name": f"request {trace_id[:8]}",
            "ts": start_us, "dur": dur_us, "pid": pid, "tid": tid,
            "args": {
                "traceId": trace_id,
                "queueMs": _f(req.get("queueMs")),
                "ttftMs": _f(req.get("ttftMs")),
                "promptTokens": int(_f(req.get("promptTokens"))),
                "tokens": int(_f(req.get("tokens"))),
                "finishReason": reason,
                "decodeTps": _f(req.get("decodeTps")),
                # Join keys into the tick rows above (and /debug/ticks).
                "firstTick": int(_f(req.get("firstTick"), -1.0)),
                "lastTick": int(_f(req.get("lastTick"), -1.0)),
                "source": req.get("source", ""),
                "constrained": bool(req.get("constrained", False)),
                # SLO-plane identity (serving/slo.py): who this request
                # was, which objective class it rode under, and whether
                # it burned the class's error budget.
                "tenant": req.get("tenant", ""),
                "qosClass": req.get("qosClass", ""),
                "sloViolated": bool(req.get("sloViolated", False)),
            },
        })
        if reason in _FAILURE_REASONS:
            events.append({
                "ph": "i", "cat": "lifecycle", "name": reason,
                "ts": start_us + dur_us, "s": "t",
                "pid": pid, "tid": tid, "args": {"traceId": trace_id},
            })
        elif bool(req.get("sloViolated", False)):
            # A request that FINISHED fine but missed its class's
            # latency objective: full-height (global-scope) instant —
            # like post-warmup compiles, the steady-state regression
            # signal should not hide at thread height. Failure reasons
            # above already mark the row; the SLO marker covers the
            # met-but-slow case they can't.
            events.append({
                "ph": "i", "cat": "slo", "name": "slo-violation",
                "ts": start_us + dur_us, "s": "g",
                "pid": pid, "tid": tid, "args": {
                    "traceId": trace_id,
                    "tenant": req.get("tenant", ""),
                    "qosClass": req.get("qosClass", ""),
                },
            })


def build_timeline(
    spans: list, backends: list, max_events: Optional[int] = None
) -> dict:
    """Merge span dicts (utils/tracing.Tracer.recent) and per-backend
    flight-record entries (ServiceDiscoverer.get_backend_flight_records
    protojson: target/enabled/ticks/requests, or target/error) into one
    Chrome trace-event document: {"traceEvents": [...],
    "displayTimeUnit": "ms"}. Events are emitted time-ordered per
    (pid, tid) track — the schema Perfetto's JSON importer expects."""
    events: list[dict] = []
    events.append(_meta(_PID_GATEWAY, 0, "process_name", "gateway"))
    live = [i for i, e in enumerate(backends or []) if "error" not in e]
    _span_events(spans or [], events,
                 _PID_GATEWAY + 1 + live[0] if live else _PID_GATEWAY)
    skipped: list[str] = []
    for i, entry in enumerate(backends or []):
        pid = _PID_GATEWAY + 1 + i
        target = str(entry.get("target", f"backend-{i}"))
        if "error" in entry:
            skipped.append(target)
            continue
        events.append(_meta(pid, 0, "process_name", f"sidecar {target}"))
        _tick_events(entry.get("ticks", []), pid, events)
        _compile_events(entry.get("compiles", []), pid, events)
        _request_events(entry.get("requests", []), pid, events)
    # Stable per-track ordering: metadata first, then by start time;
    # ties break longest-slice-first so parents precede their nested
    # phase slices.
    events.sort(key=lambda e: (
        e["pid"], e["tid"], 0 if e["ph"] == "M" else 1,
        e["ts"], -e.get("dur", 0),
    ))
    if max_events is not None and len(events) > max_events:
        events = events[:max_events]
    doc: dict = {"traceEvents": events, "displayTimeUnit": "ms"}
    if skipped:
        # Surfaced, not silent: a dead backend's absence from the
        # timeline must be visible in the document itself.
        doc["skippedBackends"] = skipped
    return doc
