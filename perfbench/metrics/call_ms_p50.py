"""Median MCP tools/call latency, from each call's due time to its
answer, over every call due in the window (open loop)."""

from perfbench import records, yardstick


def read(run: dict):
    if run["loop"] != "open":
        return None
    return yardstick.nearest_rank(
        [records.call_ms(run, c) for c in records.due_in_window(run)], 0.5)
