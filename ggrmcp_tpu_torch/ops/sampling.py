"""Token sampling: greedy, temperature, top-k, top-p. Port of
`ggrmcp_tpu/ops/sampling.py` (grammar state 0 only: the allow /
transition tables are the trivial one-state tables).

Drawing a token is two separate steps so that tests can feed both
packages the same uniforms: `counter_uniform` makes one uniform per row
from a counter-based hash of (seed, step, row), and `_invcdf_pick`
picks the token from it. The reference draws its uniform with threefry;
the draws differ, the pick does not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingConfig(NamedTuple):
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # 1 → disabled


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split c in 16-bit
    halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash on int64 tensors holding 32-bit values."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(
    seeds: torch.Tensor,  # [B] integer per-row seeds
    step,  # int or scalar tensor — the decode step
    rows: Optional[torch.Tensor] = None,  # [B] extra counter (row index)
) -> torch.Tensor:  # [B] float32 in [0, 1)
    """One uniform per row from a counter-based hash of (seed, step,
    row): stateless, identical on every device, independent across
    rows and steps."""
    s = seeds.long() & _MASK32
    x = _hash32(s ^ _hash32(torch.as_tensor(step, device=s.device).long()
                            + 0x9E3779B9))
    if rows is not None:
        x = _hash32(x ^ _hash32(rows.long() + 0x85EBCA6B))
    x = _hash32(x + 0x27D4EB2F)
    return (x >> 8).float() * (1.0 / (1 << 24))


def _invcdf_pick(u: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Categorical draw by CDF inversion from a per-row scalar uniform:
    token = #{i : cdf_i < u·mass}."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    mass = cdf[..., -1:]
    return (cdf < u[..., None] * mass).sum(dim=-1).to(torch.int32)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, logits.shape[-1])
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(
        logits < threshold, torch.full_like(logits, -float("inf")), logits
    )


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest sorted prefix with mass ≥ p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep_sorted = (cumulative - probs) < p
    cutoff = keep_sorted.sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, cutoff - 1)
    return torch.where(
        logits < threshold, torch.full_like(logits, -float("inf")), logits
    )


def sample(
    logits: torch.Tensor,  # [B, V]
    seed: int,
    step: int,
    cfg: SamplingConfig,
) -> torch.Tensor:  # [B] int32
    """Static-config sampling (the engine's whole-request path). Greedy
    when temperature <= 0; otherwise temperature → top-k → top-p, one
    counter uniform per row."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        logits = _mask_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _mask_top_p(logits, cfg.top_p)
    b = logits.shape[0]
    rows = torch.arange(b, device=logits.device)
    seeds = torch.full((b,), seed & _MASK32, device=logits.device)
    return _invcdf_pick(counter_uniform(seeds, step, rows), logits)


def dynamic_support_mask(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
) -> torch.Tensor:  # [B, V] bool
    """Tokens `sample_dynamic` can draw under per-row params: scale by
    temperature, keep ranks < top_k (0 = all), then top-p over the
    top-k-renormalized distribution (p >= 1 disables the test outright),
    always at least one token."""
    logits = logits.float()
    v = logits.shape[-1]
    safe_temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / safe_temp
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(top_k[:, None] > 0, top_k[:, None].long(), v)
    keep_k = rank < k
    probs = torch.softmax(
        torch.where(
            keep_k, sorted_logits,
            torch.full_like(sorted_logits, -float("inf")),
        ),
        dim=-1,
    )
    cumulative = torch.cumsum(probs, dim=-1)
    tp = top_p.float()[:, None]
    keep_p = ((cumulative - probs) < torch.clamp(tp, max=1.0)) | (tp >= 1.0)
    keep = keep_k & keep_p
    keep[:, 0] = True
    kept_count = keep.sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, kept_count - 1)
    return scaled >= threshold


def sample_dynamic(
    logits: torch.Tensor,  # [B, V]
    seeds: torch.Tensor,  # [B] per-request seeds
    step,  # int or scalar tensor — decode step
    temperature: torch.Tensor,  # [B]; <= 0 → greedy
    top_k: torch.Tensor,  # [B]; 0 → disabled
    top_p: torch.Tensor,  # [B]; >= 1 → disabled
) -> torch.Tensor:  # [B] int32
    """Per-row sampling with per-row parameters (the continuous batcher
    path): support mask, then one counter uniform per row."""
    logits = logits.float()
    support = dynamic_support_mask(logits, temperature, top_k, top_p)
    safe_temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = torch.where(
        support, logits / safe_temp,
        torch.full_like(logits, -float("inf")),
    )
    sampled = _invcdf_pick(counter_uniform(seeds, step), scaled)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def masked_sample_dynamic(
    logits: torch.Tensor,  # [B, V]
    seeds: torch.Tensor,  # [B]
    step,
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    state: torch.Tensor,  # [B] int — per-row grammar state (0 = none)
    allow: torch.Tensor,  # [S, V] bool
    trans: torch.Tensor,  # [S, V] int
) -> tuple[torch.Tensor, torch.Tensor]:  # (tokens [B], next state [B])
    """Grammar-masked per-row sampling: disallowed tokens become -inf
    before temperature/top-k/top-p, and each row's state advances
    through the transition table. State 0 (accept-all) passes logits
    through unchanged."""
    masked = torch.where(
        allow[state.long()], logits.float(),
        torch.full_like(logits, -float("inf"), dtype=torch.float32),
    )
    tokens = sample_dynamic(masked, seeds, step, temperature, top_k, top_p)
    nxt = torch.gather(trans[state.long()], -1, tokens.long()[:, None])[:, 0]
    return tokens, nxt


def trivial_grammar_tables(
    vocab_size: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-state (accept-all) allow / transition tables."""
    return (
        torch.ones((1, vocab_size), dtype=torch.bool, device=device),
        torch.zeros((1, vocab_size), dtype=torch.int32, device=device),
    )
