"""Median of the gateway-to-sidecar hop a call: its `gateway.invoke`
span less its request record's e2e_ms (the batcher's submit to its
terminal chunk), over the calls due in the window: the gRPC client, the
socket, the gRPC server and the sidecar's handler outside the batcher."""

from perfbench import records, spans, yardstick


def read(run: dict):
    calls = spans.window_calls(run, "gateway.invoke")
    if calls is None:
        return None
    by = records.requests_by_trace(run)
    return yardstick.median(
        c["gateway.invoke"]["ms"] - by[tid]["e2e_ms"]
        for tid, c in calls.items() if tid in by)
