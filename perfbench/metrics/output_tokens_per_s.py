"""Completion tokens of the calls answered in the window, over the
window."""

from perfbench import records


def read(run: dict):
    done = records.done_in_window(run)
    return sum(len(c["tokens"]) for c in done) / run["seconds"]
