"""95th percentile of the admission queue's wait (request records'
queue_ms) of the calls due in the window."""

from perfbench import records, yardstick


def read(run: dict):
    return yardstick.nearest_rank(
        [r["queue_ms"] for r in records.window_requests(run)], 0.95)
