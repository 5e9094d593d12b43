"""Median decode tick of the window: a tick record's duration less its
admit phase (sync, dispatch, wait and host)."""

from perfbench import records, yardstick


def read(run: dict):
    return yardstick.median(t["duration_ms"] - t["phase_admit_ms"]
                            for t in records.window_ticks(run))
