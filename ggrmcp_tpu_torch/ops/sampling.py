"""Token sampling: greedy, temperature, top-k, top-p, the grammar mask
and the forced-run lookup of jump-ahead decoding. Port of
`ggrmcp_tpu/ops/sampling.py`.

A random draw is made exactly as the reference makes it: threefry-2x32
(JAX's partitionable mode) on int64 tensors masked to 32 bits, so
`sample_dynamic` draws `uniform(fold_in(prng_key(seed), step))` bit for
bit like `jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed),
step), ())` on the CPU and on CUDA alike. `_invcdf_pick` then picks the
token from the uniform as the reference does. Vector draws (the
speculative tick's `uniform(k, (gamma,))` and `gumbel(k, (V,))`) take
word i from threefry at counter (0, i), as the partitionable layout
does for shapes of fewer than 2**32 elements.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingConfig(NamedTuple):
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # 1 → disabled


_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (Salmon et al. 2011, as `jax.random`
    runs it) on int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:  # [..., 2] int64
    """`jax.random.PRNGKey` of 32-bit seeds: the key words (0, seed)."""
    seed = seed.long() & _MASK32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry of the counter (0, data) under
    `key`. `data` is an int or a tensor; it and the key broadcast."""
    d = torch.as_tensor(data, device=key.device).long() & _MASK32
    k0, k1, d = torch.broadcast_tensors(key[..., 0], key[..., 1], d)
    x0, x1 = _threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` per key ([..., 2] → [..., n] int64
    holding 32-bit words): word i is the xor of threefry's two words at
    counter (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1, x1 = torch.broadcast_tensors(key[..., 0:1], key[..., 1:2], i)
    b0, b1 = _threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return b0 ^ b1


def uniform(key: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """`jax.random.uniform(key, ())` per key ([...] float32 in [0, 1)),
    or `jax.random.uniform(key, (n,))` ([..., n]): the top 23 bits of
    each word become the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, 1 if n is None else n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u[..., 0] if n is None else u


_TINY = torch.finfo(torch.float32).tiny


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:  # [..., n] float32
    """`jax.random.gumbel(key, (n,))` per key: -log(-log(u)) of the
    uniform over [tiny, 1) made as `jax.random._uniform` makes it
    (u * (1 - tiny) + tiny, at least tiny; float32 rounds 1 - tiny to
    1). The bits are exact; the logs round as the device's `log` does."""
    u = torch.clamp(uniform(key, n) * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


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
    when temperature <= 0; otherwise temperature → top-k → top-p, then
    row r draws from the step key `fold_in(prng_key(seed), step)` with
    r folded in, as the reference engine and `sample` draw."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        logits = _mask_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _mask_top_p(logits, cfg.top_p)
    rows = torch.arange(logits.shape[0], device=logits.device)
    key = fold_in(prng_key(torch.tensor(seed, device=logits.device)), step)
    return _invcdf_pick(uniform(fold_in(key, rows)), logits)


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
    path): support mask, then row r draws
    `uniform(fold_in(prng_key(seeds[r]), step))`."""
    logits = logits.float()
    support = dynamic_support_mask(logits, temperature, top_k, top_p)
    safe_temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = torch.where(
        support, logits / safe_temp,
        torch.full_like(logits, -float("inf")),
    )
    u = uniform(fold_in(prng_key(seeds.to(logits.device)), step))
    sampled = _invcdf_pick(u, scaled)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def filtered_logprobs(
    logits: torch.Tensor,  # [B, V] (grammar-masked rows arrive as -inf)
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
) -> torch.Tensor:  # [B, V] float32 log-probs
    """Log-probs of the temperature → top-k → top-p filtered distribution
    `sample_dynamic` draws from; tokens outside the support are -inf."""
    support = dynamic_support_mask(logits, temperature, top_k, top_p)
    safe_temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    return torch.log_softmax(
        torch.where(support, logits.float() / safe_temp,
                    torch.full_like(logits, -float("inf"),
                                    dtype=torch.float32)),
        dim=-1,
    )


def masked_sample_dynamic(
    logits: torch.Tensor,  # [B, V]
    seeds: torch.Tensor,  # [B]
    step,
    temperature: Optional[torch.Tensor],  # [B]; None = every row greedy
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    state: torch.Tensor,  # [B] int — per-row grammar state (0 = none)
    allow: torch.Tensor,  # [S, V] bool
    trans: torch.Tensor,  # [S, V] int
) -> tuple[torch.Tensor, torch.Tensor]:  # (tokens [B], next state [B])
    """Grammar-masked per-row sampling: disallowed tokens become -inf
    before temperature/top-k/top-p, and each row's state advances
    through the transition table. State 0 (accept-all) passes logits
    through unchanged. `temperature` None says no row samples (the
    caller knows it on the host): the tokens are then the masked argmax,
    `sample_dynamic`'s greedy rows, without its sort and its draw, each
    of which costs hundreds of small launches on the card."""
    state = state.long()
    masked = torch.where(
        allow[state], logits.float(),
        torch.full_like(logits, -float("inf"), dtype=torch.float32),
    )
    if temperature is None:
        tokens = torch.argmax(masked, dim=-1).to(torch.int32)
    else:
        tokens = sample_dynamic(masked, seeds, step, temperature, top_k,
                                top_p)
    return tokens, trans[state, tokens.long()].long()


def forced_run_lookup(
    state: torch.Tensor,  # [B] — per-row grammar state
    jump_len: torch.Tensor,  # [S] — forced-run length per state
    jump_tokens: torch.Tensor,  # [S, J] — run token ids
    jump_states: torch.Tensor,  # [S, J] — absolute states along the run
    jump_ok: torch.Tensor,  # [B] bool — per-slot jump enable
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row forced-run gather of the jump-ahead tick: (run_len [B],
    run_tokens [B, J], landing [B]). run_len is 0 for state 0 and for
    rows with jump_ok False; landing is the absolute state after the run
    (the state itself when run_len is 0), which the post-run sample is
    masked under."""
    state = state.long()
    length = torch.where(jump_ok, jump_len[state].long(),
                         torch.zeros_like(state))
    run_tokens = jump_tokens[state].long()
    last = torch.clamp(length - 1, min=0)[:, None]
    landing = torch.where(
        length > 0, torch.gather(jump_states[state].long(), 1, last)[:, 0],
        state,
    )
    return length, run_tokens, landing


def trivial_grammar_tables(
    vocab_size: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-state (accept-all) allow / transition tables."""
    return (
        torch.ones((1, vocab_size), dtype=torch.bool, device=device),
        torch.zeros((1, vocab_size), dtype=torch.int32, device=device),
    )
