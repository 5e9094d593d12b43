"""95th percentile of the time to the first token on the sidecar's side
(request records' ttft_ms) of the calls due in the window."""

from perfbench import records, yardstick


def read(run: dict):
    return yardstick.nearest_rank(
        [r["ttft_ms"] for r in records.window_requests(run)
         if r["ttft_ms"] > 0], 0.95)
