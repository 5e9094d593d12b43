"""Admission time per 1000 prompt tokens admitted: the admit phases of
the ticks dispatched in the window, over the prompt tokens of the
requests admitted in it."""

from perfbench import records


def read(run: dict):
    toks = sum(r["prompt_tokens"] for r in records.admitted_in_window(run))
    if not toks:
        return None
    ms = sum(t["phase_admit_ms"] for t in records.window_ticks(run))
    return ms / (toks / 1000.0)
