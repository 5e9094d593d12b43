"""The yardstick: the card's published peaks, the percentile, and the
work that a model's inputs need, counted from shapes.

The arithmetic is the benchmark's own, frozen beside it: the percentile
is a copy of `ggrmcp_tpu_torch/utils/stats.py::nearest_rank`, the
attention bound of `chip_smoke.py`'s B1 rows, the expert work of its
`_ffn_bound_ms`. Work is what the inputs need, whatever computes it:
positions past a row's length, padding rows and empty expert capacity
count for nothing.
"""

from __future__ import annotations

import statistics

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2


def nearest_rank(values, p: float) -> float:
    """The ceil(n·p)-th smallest value; None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    idx = max(0, -(-len(vals) * p // 1) - 1)
    return float(vals[min(len(vals) - 1, int(idx))])


def median(values):
    vals = list(values)
    return float(statistics.median(vals)) if vals else None


def causal_pairs(n: int, window: int | None) -> int:
    """(query, key) pairs a causal prompt of n tokens attends, per head:
    key j is seen by query i when i - window < j <= i."""
    if not window or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def prompt_attention(m: dict, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one prompt's attention over all layers: 4·Dh
    FLOPs a (query head, key) pair; Q read and O written once, each
    key's K and V read once, bf16."""
    pairs = causal_pairs(n, m["window"])
    flops = 4.0 * pairs * m["heads"] * m["head_dim"] * m["layers"]
    nbytes = BF16 * n * m["head_dim"] * m["layers"] * (
        2 * m["heads"] + 2 * m["kv_heads"])
    return flops, nbytes


def attention_bound_s(m: dict, n: int) -> float:
    """The least time of one prompt's attention on the card: the larger
    of its FLOPs over the bf16 peak and its bytes over the memory rate."""
    flops, nbytes = prompt_attention(m, n)
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


def dense_flops_per_token(m: dict) -> float:
    """2 FLOPs a weight a token through the weights each token uses:
    attention projections, the FFN (top-k experts of a MoE) and the
    head; the embedding is a lookup."""
    d, hd = m["hidden"], m["head_dim"]
    attn = d * (m["heads"] + 2 * m["kv_heads"]) * hd + m["heads"] * hd * d
    ffn = 3 * d * m["ffn"] * m.get("experts_per_token", 1)
    router = d * m.get("experts", 0)
    return 2.0 * (m["layers"] * (attn + ffn + router) + d * m["vocab"])


def token_flops(m: dict, position: int) -> float:
    """FLOPs of the token at `position` (0-based) of a sequence: its
    weights and its causal attention over position + 1 keys."""
    keys = min(position + 1, m["window"] or position + 1)
    return dense_flops_per_token(m) + (
        4.0 * keys * m["heads"] * m["head_dim"] * m["layers"])


def prompt_flops(m: dict, n: int) -> float:
    return dense_flops_per_token(m) * n + prompt_attention(m, n)[0]


def weight_bytes_read_per_tick(m: dict, rows: int) -> float:
    """Bytes of weights one decode step must read: every layer's
    weights once (every expert of a MoE: a step of `rows` tokens routes
    to nearly all of them), the final norm and the head, and one
    embedding row a token."""
    d, hd = m["hidden"], m["head_dim"]
    attn = d * (m["heads"] + 2 * m["kv_heads"]) * hd + m["heads"] * hd * d
    ffn = 3 * d * m["ffn"] * m.get("experts", 1)
    per_layer = attn + ffn + 2 * d
    return BF16 * (m["layers"] * per_layer + d + d * m["vocab"]
                   + rows * d) + 4.0 * m["layers"] * d * m.get("experts", 0)


def kv_bytes(m: dict, length: int) -> float:
    """Bytes of one row's cached K and V up to `length` positions."""
    keys = min(length, m["window"] or length)
    return BF16 * 2 * keys * m["kv_heads"] * m["head_dim"] * m["layers"]


def window_mfu(run: dict) -> float:
    """The whole step's share of the card's bf16 peak over the window:
    the FLOPs that the prompts admitted in it and the tokens its ticks
    decoded need, over the window at the peak. In %; None for no work."""
    from perfbench import records

    m, by = run["m"], records.requests_by_trace(run)
    flops = sum(prompt_flops(m, r["prompt_tokens"])
                for r in records.admitted_in_window(run))
    for t in records.window_ticks(run):
        flops += sum(token_flops(m, n - 1)
                     for n in records.live_lengths(run, t, by))
    if not flops:
        return None
    return 100.0 * flops / (run["seconds"] * PEAK_FLOPS_BF16)


def idle_share(run: dict):
    """Share of the profiled slice with nothing running on the device.
    In %; None without a slice."""
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
