"""`loop_turn_ms.<cells>`: the serving loop's host time between ticks
with work in hand: the median, over the `batcher.turn` spans that start
in the window and never waited for work (no `batcher.wait_work` child),
of the turn less its admission rounds (`batcher.admit` children)."""

from perfbench import spans, yardstick


def read(run: dict):
    turns = spans.window_turns(run)
    if turns is None:
        return None
    return yardstick.median(
        turn["ms"] - sum(c["ms"] for c in kids if c["name"] == "batcher.admit")
        for turn, kids in turns
        if not any(c["name"] == "batcher.wait_work" for c in kids))
