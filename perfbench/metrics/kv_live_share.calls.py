"""How much of the KV cache pool the window's decode ticks hold: each
live row's cached positions, summed over the rows of a tick and
averaged over the window's ticks, over the pool's slots x positions.
In %."""

from perfbench import records


def read(run: dict):
    by = records.requests_by_trace(run)
    held = [sum(records.live_lengths(run, t, by))
            for t in records.window_ticks(run)]
    if not held:
        return None
    pool = run["pool"]["slots"] * run["pool"]["positions"]
    return 100.0 * sum(held) / len(held) / pool
