"""Median of each call's client-side time less its request record's
e2e_ms (the batcher's submit to terminal): the gateway, the gRPC hop
and the sidecar's handler around the batcher."""

from perfbench import records, traffic, yardstick


def read(run: dict):
    by = records.requests_by_trace(run)
    out = []
    for c in records.due_in_window(run):
        r = by.get(traffic.trace_id(run["seed"], c["index"]))
        if c["ok"] and r is not None:
            out.append((c["done"] - c["sent"]) * 1e3 - r["e2e_ms"])
    return yardstick.median(out)
