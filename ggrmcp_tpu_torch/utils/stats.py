"""Shared percentile math (no jax/numpy — importable from the light
gateway/bench paths).

One formula for every latency percentile the project reports: the
ceil-based nearest-rank used by ContinuousBatcher.lat_percentiles since
round 4. bench.py previously hand-rolled `int(n*p)-1`, which reads ~p98
at n=63 and indexes -1 at n<2 (round-5 issue list)."""

from __future__ import annotations


def nearest_rank(vals: list[float], p: float) -> float:
    """The ceil(n*p)-th smallest value (nearest-rank percentile): at
    n=100, p99 is vals[98], not the window max; at n=1 any p returns
    the single sample. Returns 0.0 for an empty list."""
    if not vals:
        return 0.0
    vals = sorted(vals)
    idx = max(0, -(-len(vals) * p // 1) - 1)
    return vals[min(len(vals) - 1, int(idx))]


def pct(vals: list[float], p: float) -> float:
    """nearest_rank rounded to 2 decimals — the one reporting wrapper
    for every percentile the project exports (batcher lat/stall
    percentiles, bench extras, flight-recorder request records), so a
    rounding-policy change can never fork between surfaces."""
    return round(nearest_rank(vals, p), 2)
