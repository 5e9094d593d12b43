"""The one traffic generator: a traffic file's parameters and a seed give
every call of a run, the same calls for the same seed.

Standard library only: the load generator (loadgen.py), a process of
its own, imports it, and so does the harness, which rebuilds the prompts
of the calls it judges.

A traffic file (`workloads/<traffic>.json`) holds:

- `loop`: "open" (calls due at `rate_per_s` on average, as Poisson
  arrivals, whatever the server does) or "closed" (`clients` callers,
  each sending its next call when its last one returns);
- `prompt_tokens`, `output_tokens`: {"dist": "uniform" | "loguniform",
  "min": a, "max": b}, whole token counts in [a, b]; a prompt's count
  includes its BOS;
- `lead_s`: how long the traffic runs before the measured window opens
  (one call's length or more, so that the pool is at steady state);
- `trace_slice_s`: how long the profiler records in a `--trace 1` run,
  after the window, while the traffic goes on;
- `judge`: how many calls the reference checks (`min_tokens` served
  tokens at least, `max_calls` calls at most).

Every seed offers the same work in another order. Lengths: each block
of BLOCK calls holds the same BLOCK quantiles of each distribution, in
an order drawn from the seed. Arrivals: a Poisson process given its
count in each stretch of the schedule (lead-in, window, tail):
round(rate x length) arrivals, each placed uniformly at random over its
stretch, which is how a Poisson process places the points it holds.
Gaps are then exponential in law, with the bursts and long lulls that
brings; only the number of calls due in the window is fixed.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

BLOCK = 32
BOS = 1
# Ids below this are the byte tokenizer's specials (pad, BOS, EOS).
FIRST_ID = 3


def load(path: Path) -> dict:
    with open(path) as fh:
        spec = json.load(fh)
    if spec["loop"] not in ("open", "closed"):
        raise ValueError(f"{path}: loop must be open or closed")
    if spec["loop"] == "open" and not spec.get("rate_per_s", 0) > 0:
        raise ValueError(f"{path}: an open loop needs rate_per_s > 0")
    if spec["loop"] == "closed" and not spec.get("clients", 0) > 0:
        raise ValueError(f"{path}: a closed loop needs clients > 0")
    for key in ("prompt_tokens", "output_tokens"):
        d = spec[key]
        if d["dist"] not in ("uniform", "loguniform") or not (
                1 <= d["min"] <= d["max"]):
            raise ValueError(f"{path}: bad {key} {d}")
    return spec


def _quantile(dist: dict, u: float) -> int:
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    else:
        x = math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return min(int(hi), max(int(lo), int(x)))


def _stratified(rng: random.Random, n: int, value, block: int) -> list:
    """n values, each block the same `block` quantiles shuffled."""
    base = [value((i + 0.5) / block) for i in range(block)]
    out: list = []
    while len(out) < n:
        shuffled = list(base)
        rng.shuffle(shuffled)
        out.extend(shuffled)
    return out[:n]


def calls(spec: dict, seed: int, n: int) -> list[dict]:
    """The first `n` calls of a run: index, prompt length and output
    length."""
    rng = random.Random(f"perfbench-traffic:{seed}")
    prompts = _stratified(
        rng, n, lambda u: _quantile(spec["prompt_tokens"], u), BLOCK)
    outputs = _stratified(
        rng, n, lambda u: _quantile(spec["output_tokens"], u), BLOCK)
    return [dict(index=i, prompt_len=prompts[i], max_new=outputs[i])
            for i in range(n)]


def arrivals(spec: dict, seed: int, stretches: list[float]) -> list[float]:
    """An open loop's due times, in seconds after the schedule's start,
    for consecutive stretches of the given lengths."""
    rng = random.Random(f"perfbench-arrivals:{seed}")
    rate = float(spec["rate_per_s"])
    out, start = [], 0.0
    for length in stretches:
        n = round(rate * length)
        out += sorted(start + rng.random() * length for _ in range(n))
        start += length
    return out


def open_calls(spec: dict, seed: int, stretches: list[float]) -> list[dict]:
    """An open loop's calls, each with its due time `due_s`."""
    due = arrivals(spec, seed, stretches)
    out = calls(spec, seed, len(due))
    for call, t in zip(out, due):
        call["due_s"] = t
    return out


def prompt_ids(seed: int, index: int, length: int, vocab: int) -> list[int]:
    """Call `index`'s prompt: BOS, then ids drawn uniformly over the
    vocabulary past the specials."""
    rng = random.Random(f"perfbench-prompt:{seed}:{index}")
    return [BOS] + rng.choices(range(FIRST_ID, vocab), k=length - 1)


def trace_id(seed: int, index: int) -> str:
    return f"pb-{seed}-{index}"


def call_body(tool: str, ids: list[int], max_new: int, index: int) -> bytes:
    """The MCP `tools/call` of the Generate tool: greedy, ids given,
    tokens returned."""
    return json.dumps({
        "jsonrpc": "2.0", "method": "tools/call", "id": index,
        "params": {"name": tool, "arguments": {
            "promptIds": {"dtype": "int32", "shape": [len(ids)],
                          "intValues": ids},
            "maxNewTokens": max_new, "returnTokens": True}},
    }, separators=(",", ":")).encode()
