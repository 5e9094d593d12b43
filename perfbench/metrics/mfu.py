"""`mfu.<cells>`: the whole step's share of the card's bf16 peak: the
FLOPs that the prompts admitted in the window and the tokens its ticks
decoded need (weights a token, the top-k experts of a MoE, causal
attention pairs), over the window at 989 TFLOP/s. In %."""

from perfbench import yardstick


def read(run: dict):
    return yardstick.window_mfu(run)
