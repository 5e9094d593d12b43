"""Median of the gateway's own time a call: its `gateway.http` span
(the complete body to the written response) less its `gateway.invoke`
(the backend RPC as the gateway awaits it), over the calls due in the
window."""

from perfbench import spans, yardstick


def read(run: dict):
    calls = spans.window_calls(run, "gateway.http", "gateway.invoke")
    if calls is None:
        return None
    return yardstick.median(
        c["gateway.http"]["ms"] - c["gateway.invoke"]["ms"]
        for c in calls.values() if len(c) == 2)
