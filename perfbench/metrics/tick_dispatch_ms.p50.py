"""Median dispatch phase (the host launching the tick's kernels) of the
window's decode ticks."""

from perfbench import records, yardstick


def read(run: dict):
    return yardstick.median(t["phase_dispatch_ms"]
                            for t in records.window_ticks(run))
