"""95th percentile of the MCP tools/call latency, from each call's due
time to its answer, over every call due in the window (open loop); a
call never answered counts as waiting until the drain gave up."""

from perfbench import records, yardstick


def read(run: dict):
    if run["loop"] != "open":
        return None
    return yardstick.nearest_rank(
        [records.call_ms(run, c) for c in records.due_in_window(run)], 0.95)
