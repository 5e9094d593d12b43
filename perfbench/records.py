"""What a run recorded, and the selections every metric shares.

A run record is a dict: `calls` (the load generator's, one per call,
times in wall seconds), `w0` / `w1` (the window), `seconds`, `setup_s`,
`loop` ("open" / "closed"), `ticks` and `requests` (the flight
recorder's tick and request records, read through GetFlightRecord),
`m` (the model's sizes, model.shape), `seed`, and with `--trace 1`
`trace` (devtrace.Slice.read: the profiled slice after the window).
"""

from __future__ import annotations

from perfbench import traffic

TICK_FIELDS = ("seq", "t_wall", "duration_ms", "phase_admit_ms",
               "phase_sync_ms", "phase_dispatch_ms", "phase_wait_ms",
               "phase_host_ms")
REQUEST_FIELDS = ("trace_id", "t_submit", "queue_ms", "ttft_ms", "e2e_ms",
                  "prompt_tokens", "first_tick")


def tick_dict(t) -> dict:
    out = {f: getattr(t, f) for f in TICK_FIELDS}
    out["trace_ids"] = list(t.trace_ids)
    return out


def request_dict(r) -> dict:
    return {f: getattr(r, f) for f in REQUEST_FIELDS}


def due_in_window(run: dict) -> list[dict]:
    """The calls due in the window: scheduled in it (open loop) or sent
    in it (closed loop)."""
    key = "due" if run["loop"] == "open" else "sent"
    return [c for c in run["calls"]
            if c[key] is not None and run["w0"] <= c[key] < run["w1"]]


def done_in_window(run: dict) -> list[dict]:
    """The calls answered well inside the window."""
    return [c for c in run["calls"] if c["ok"] and c["done"] is not None
            and run["w0"] <= c["done"] < run["w1"]]


def call_ms(run: dict, call: dict) -> float:
    """A call's latency from its due time; one never answered waited
    until the drain gave up."""
    end = call["done"] if call["ok"] else run["given_up"]
    return (end - call["due"]) * 1e3


def requests_by_trace(run: dict) -> dict:
    return {r["trace_id"]: r for r in run["requests"]}


def window_requests(run: dict) -> list[dict]:
    """Request records of the calls due in the window."""
    by = requests_by_trace(run)
    ids = (traffic.trace_id(run["seed"], c["index"])
           for c in due_in_window(run))
    return [by[i] for i in ids if i in by]


def window_ticks(run: dict) -> list[dict]:
    """Tick records dispatched in the window."""
    return [t for t in run["ticks"] if run["w0"] <= t["t_wall"] < run["w1"]]


def admitted_in_window(run: dict) -> list[dict]:
    """Request records whose admission ended in the window."""
    return [r for r in run["requests"] if r["first_tick"] >= 0
            and run["w0"] <= r["t_submit"] + r["queue_ms"] * 1e-3 < run["w1"]]


def live_lengths(run: dict, tick: dict, by: dict) -> list[int]:
    """The cache length each live row of `tick` reads: its prompt, its
    first token (from admission) and one position a tick since."""
    out = []
    for tid in tick["trace_ids"]:
        r = by.get(tid)
        if r is not None:
            out.append(r["prompt_tokens"] + (tick["seq"] - r["first_tick"])
                       + 1)
    return out
