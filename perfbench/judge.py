"""How `correct` is decided: every call due in the window answered, each
answer well formed, and a sample of the served tokens held against the
plain reference.

The sample is drawn from the seed among the calls due in the window
that were answered, the call with the longest sequence always in it,
until it holds `min_tokens` served tokens or `max_calls` calls. The
reference runs each prompt followed by its served tokens once and reads,
at each served token's position, how far that token's logit lies below
the reference's best (greedy decoding serves the best token, so a sound
program's gap is rounding). A call that stopped at EOS is judged on its
EOS too. The numbers compared with the cell's limits (limits/README.md)
are taken from these gaps by `numbers`.

`low` puts the reference at a lower precision in the program's place:
at the same positions it reads the gap of the token that the reference
computed in float8 (the control) or in bfloat16 (a witness) puts first,
and those gaps are judged as the program's would be.
"""

from __future__ import annotations

import random

import torch

from perfbench import traffic
from perfbench.reference.plain import Plain

EOS = 2


def well_formed(call: dict) -> str:
    """'' when a call's answer is what was asked for, else why not. The
    EOS that ends a "stop" is not among the ids returned."""
    toks = call.get("tokens") or []
    finish = call.get("finish")
    if call.get("prompt_tokens") != call["prompt_len"]:
        return f"promptTokens {call.get('prompt_tokens')} != {call['prompt_len']}"
    if call.get("completion_tokens") != len(toks):
        return f"completionTokens {call.get('completion_tokens')} for {len(toks)} ids"
    if finish == "length" and len(toks) != call["max_new"]:
        return f"finish length after {len(toks)} of {call['max_new']}"
    if finish == "stop" and (len(toks) >= call["max_new"] or EOS in toks):
        return f"finish stop after {len(toks)} of {call['max_new']}"
    if finish not in ("length", "stop"):
        return f"finish {finish!r}"
    return ""


def judged_tokens(call: dict) -> list[int]:
    return call["tokens"] + ([EOS] if call["finish"] == "stop" else [])


def pick(calls: list[dict], seed: int, min_tokens: int,
         max_calls: int) -> list[dict]:
    """The sample: the longest call, then calls in an order drawn from
    the seed."""
    if not calls:
        return []
    rng = random.Random(f"perfbench-judge:{seed}")
    longest = max(calls, key=lambda c: (c["prompt_len"] + len(c["tokens"]),
                                        c["index"]))
    rest = sorted((c for c in calls if c is not longest),
                  key=lambda c: c["index"])
    rng.shuffle(rest)
    out, served = [longest], len(judged_tokens(longest))
    for c in rest:
        if served >= min_tokens or len(out) >= max_calls:
            break
        out.append(c)
        served += len(judged_tokens(c))
    return out


def gaps(m: dict, weights: dict, sample: list[dict], seed: int,
         low: str | None = None) -> list[list]:
    """Per served token of the sample: [the program's gap, the
    reference's routing margin (a MoE's; None for a dense model)], and
    with `low` ("fp8" or "bf16") a third entry, the gap of the lower
    precision's first choice."""
    seqs, positions, served = [], [], []
    for c in sample:
        prompt = traffic.prompt_ids(seed, c["index"], c["prompt_len"],
                                    m["vocab"])
        toks = judged_tokens(c)
        seqs.append(prompt + toks[:-1])
        positions.append(list(range(len(prompt) - 1,
                                    len(prompt) - 1 + len(toks))))
        served.append(toks)
    plain = Plain(m, "fp32")
    ref = plain.logits(weights, seqs, positions)
    per_token = []
    for j, (logits, toks) in enumerate(zip(ref, served)):
        idx = torch.tensor(toks, device=logits.device)[:, None]
        gap = logits.max(-1).values - logits.gather(1, idx)[:, 0]
        margin = (plain.margins[j].tolist() if m["family"] == "moe"
                  else [None] * len(toks))
        per_token += [[g, mg] for g, mg in zip(gap.tolist(), margin)]
    if low is not None:
        lows = Plain(m, low).logits(weights, seqs, positions)
        low_gap = []
        for logits, lo in zip(ref, lows):
            first = lo.argmax(-1, keepdim=True)
            low_gap += (logits.max(-1).values
                        - logits.gather(1, first)[:, 0]).tolist()
        for row, g in zip(per_token, low_gap):
            row.append(g)
    return per_token


def numbers(per_token: list[list], col: int, clear_margin: float) -> dict:
    """The readings of one side (column `col` of `gaps`' rows): the
    widest gap, the mean gap, how many tokens were not the reference's
    best, and for a MoE the widest gap over the tokens whose every
    routing choice in the reference won by `clear_margin` or more
    (bf16 rounding may swap an expert only where one nearly ties)."""
    gap = [row[col] for row in per_token]
    routed = [row for row in per_token if row[1] is not None]
    clear = [row[col] for row in routed if row[1] >= clear_margin]
    return dict(tokens=len(gap),
                max_gap=max(gap) if gap else None,
                mean_gap=sum(gap) / len(gap) if gap else None,
                not_best=sum(g > 0 for g in gap),
                clear_tokens=len(clear),
                # Gaps are >= 0: over no clear token nothing lies below.
                clear_max_gap=max(clear, default=0.0) if routed else None)
