"""Speculative decoding: a small draft model proposes gamma tokens a
round and the target verifies all of them in ONE (gamma+1)-position
forward. Port of `ggrmcp_tpu/ops/speculative.py`.

Two per-row acceptance modes share one round:

- greedy (temperature 0): a proposal is accepted iff it equals the
  target's argmax at its position, so the emitted sequence is the
  target's greedy sequence whatever the draft proposes;
- sampled (temperature > 0): rejection sampling (Leviathan et al. 2023;
  Chen et al. 2023). The draft samples x from q, x is accepted with
  probability min(1, p(x) / q(x)), the first rejection draws its
  correction from normalize(max(p - q, 0)), so the emitted tokens are
  distributed as target-only sampling (in distribution, not bitwise).

The reference runs a generation as one jitted program (`lax.while_loop`
over rounds, the draft loop a `lax.scan`); here the loops are Python
loops over eager launches. Caches are written in place and rolled back
by setting their length: positions past it are dead under the causal
length mask and overwritten by the next round. The draws are the
reference's (ops/sampling.py's threefry, bit for bit); only the floats
derived from them round as this device's `log` and `exp` do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.ops.sampling import (
    filtered_logprobs,
    fold_in,
    gumbel,
    prng_key,
    uniform,
)


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_budget] — includes the eos
    out_len: torch.Tensor  # [B] — tokens up to and including first eos
    rounds: int  # verify rounds run
    drafted: int  # draft tokens proposed
    accepted: int  # draft tokens accepted


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b]] for t [B, N, ...] and idx [B]."""
    return t[torch.arange(t.shape[0], device=t.device), idx.long()]


def _emit(proposals, a, correction):
    """[d_1..d_a, correction, 0...] as [B, gamma + 1]."""
    gamma = proposals.shape[1]
    idx = torch.arange(gamma + 1, device=a.device)[None, :]
    padded = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], 1)
    return torch.where(
        idx < a[:, None], padded,
        torch.where(idx == a[:, None], correction[:, None].long(),
                    torch.zeros_like(padded)),
    )


def _prev_after(proposals, a, cur):
    """The last committed token before the correction: d_a, or cur when
    nothing was accepted."""
    last = _gather(proposals, torch.clamp(a - 1, min=0))
    return torch.where(a == 0, cur.long(), last)


def speculative_generate(
    target_params,
    target_cfg: llama_mod.LlamaConfig,
    draft_params,
    draft_cfg: llama_mod.LlamaConfig,
    tokens: torch.Tensor,  # [B, S] right-padded prompts
    true_len: torch.Tensor,  # [B]
    max_new_budget: int,
    gamma: int,
    eos_id: int,
    make_cache,  # (batch, length) -> target cache (an engine's)
    make_draft_cache,  # (batch, length) -> draft cache
    max_new: Optional[int] = None,  # per-call cap <= max_new_budget
    use_flash: Optional[bool] = None,
    verify_flash: Optional[bool] = None,
    temperature: Optional[torch.Tensor] = None,  # [B]; None = all greedy
    seeds: Optional[torch.Tensor] = None,  # [B] per-row seeds
) -> SpecResult:
    """Generate up to `max_new` tokens per row, speculatively (dense
    Llama target and draft sharing one vocabulary). `temperature=None`
    runs the greedy rounds, which draw nothing; a [B] tensor samples its
    rows > 0 by rejection and keeps its 0 rows exact-match greedy.
    `use_flash` rides every prefill and draft step, `verify_flash` the
    target's (gamma+1)-wide verify. Each round reads one flag from the
    device to decide whether another is needed: one sync a round. The
    caches come from `make_cache` / `make_draft_cache` (an engine's,
    in its KV dtype and placed on its mesh)."""
    b, s = tokens.shape
    dev = tokens.device
    max_new = min(max_new_budget if max_new is None else max_new,
                  max_new_budget)
    sampled_mode = temperature is not None
    vocab = target_cfg.vocab_size
    if sampled_mode:
        temperature = temperature.to(dev, torch.float32)
        is_sampled = temperature > 0.0
        safe_t = torch.clamp(temperature, min=1e-6)[:, None]
        row_keys = prng_key(seeds.to(dev))

        def draw(logits, keys):
            """Gumbel-trick temperature sample where sampled, argmax
            where greedy."""
            samp = torch.argmax(logits / safe_t + gumbel(keys, vocab), -1)
            return torch.where(is_sampled, samp, torch.argmax(logits, -1))
    budget = s + max_new_budget + gamma + 2  # the verify may overshoot
    tcache, dcache = make_cache(b, budget), make_draft_cache(b, budget)

    tlogits, _ = llama_mod.forward(target_params, target_cfg, tokens, tcache,
                                   use_flash=use_flash)
    llama_mod.forward(draft_params, draft_cfg, tokens, dcache,
                      use_flash=use_flash)
    last_idx = torch.clamp(true_len.long() - 1, min=0)
    last_logits = _gather(tlogits, last_idx)
    if sampled_mode:
        first = draw(last_logits, fold_in(row_keys, 0))
    else:
        first = torch.argmax(last_logits, -1)
    # Roll both caches back to the true prompt length; the draft one
    # more, since each round re-feeds [prev, cur] (prev rewrites its own
    # slot).
    tcache.length = true_len.to(dev, torch.int32)
    dcache.length = torch.clamp(true_len.to(dev, torch.int32) - 1, min=0)
    prev = _gather(tokens.long(), last_idx)
    cur = first.long()

    # Column max_new_budget is scratch: masked writes land there.
    out = torch.zeros((b, max_new_budget + 1), dtype=torch.long, device=dev)
    out[:, 0] = cur
    out_len = torch.ones((b,), dtype=torch.long, device=dev)
    has_eos = cur == eos_id
    rows = torch.arange(b, device=dev)[:, None]
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    rounds = 0
    drafted = torch.zeros((), dtype=torch.long, device=dev)
    accepted = torch.zeros((), dtype=torch.long, device=dev)

    def dstep(toks):
        logits, _ = llama_mod.forward(draft_params, draft_cfg, toks, dcache,
                                      use_flash=use_flash)
        return logits[:, -1]

    while bool(torch.any(~has_eos & (out_len < max_new))):
        tlen, dlen = tcache.length, dcache.length
        if sampled_mode:
            # Per-round, per-row keys: seed ⊕ round ⊕ tag (1..gamma the
            # draft draws, 700 the uniforms, 900 the residual).
            rk = fold_in(row_keys, rounds + 1)
        props, qs = [], []
        lg = dstep(torch.stack([prev, cur], dim=1))
        for j in range(1, gamma + 1):
            if sampled_mode:
                tok = draw(lg, fold_in(rk, j))
                qs.append(torch.log_softmax(lg / safe_t, dim=-1))
            else:
                tok = torch.argmax(lg, -1)
            props.append(tok)
            if j < gamma:
                lg = dstep(tok[:, None])
        proposals = torch.stack(props, dim=1)  # [B, gamma]
        verify_in = torch.cat([cur[:, None], proposals], dim=1)
        vlogits, _ = llama_mod.forward(target_params, target_cfg, verify_in,
                                       tcache, use_flash=verify_flash)
        greedy = torch.argmax(vlogits, -1)  # [B, gamma + 1]
        if sampled_mode:
            qlogp = torch.stack(qs, dim=1)  # [B, gamma, V]
            vlogp = torch.log_softmax(vlogits / safe_t[:, :, None], dim=-1)
            u = uniform(fold_in(rk, 700), gamma)
            logp_x = torch.gather(vlogp[:, :gamma], 2, proposals[..., None])
            logq_x = torch.gather(qlogp, 2, proposals[..., None])
            match = torch.where(
                is_sampled[:, None], torch.log(u) < (logp_x - logq_x)[..., 0],
                proposals == greedy[:, :gamma],
            )
        else:
            match = proposals == greedy[:, :gamma]
        a = torch.cumprod(match.long(), dim=1).sum(dim=1)  # [B] in [0, gamma]
        correction = _gather(greedy, a)
        if sampled_mode:
            # The residual max(p - q, 0) at the first rejection; p itself
            # after gamma acceptances.
            p_a = torch.exp(_gather(vlogp, a))
            q_a = torch.exp(_gather(qlogp, torch.clamp(a, max=gamma - 1)))
            resid = torch.clamp(p_a - q_a, min=0.0)
            resid = torch.where((a == gamma)[:, None], p_a, resid)
            g2 = gumbel(fold_in(rk, 900), vocab)
            samp_corr = torch.argmax(torch.log(resid + 1e-30) + g2, -1)
            correction = torch.where(is_sampled, samp_corr, correction)

        cand = _emit(proposals, a, correction)
        c = a + 1
        # A row is live until EOS or its cap: capped rows stop advancing
        # their caches and the statistics.
        live = ~has_eos & (out_len < max_new)
        pos = out_len[:, None] + idx
        write = live[:, None] & (idx < c[:, None]) & (pos < max_new)
        out[rows, torch.where(write, pos, max_new_budget)] = cand
        out_len = out_len + torch.where(
            live, torch.minimum(c, max_new - out_len),
            torch.zeros_like(c))
        has_eos = has_eos | (
            torch.where(write, cand, torch.full_like(cand, -1)) == eos_id
        ).any(dim=1)
        # Target consumed [cur, d_1..d_gamma]: the valid prefix ends at
        # d_a. The draft's next feed is [d_a, correction], d_a rewriting
        # its own slot.
        tcache.length = torch.where(live, tlen + a + 1, tlen).to(torch.int32)
        dcache.length = torch.where(live, dlen + 1 + a, dlen).to(torch.int32)
        prev = torch.where(live, _prev_after(proposals, a, cur), prev)
        cur = torch.where(live, correction.long(), cur)
        rounds += 1
        drafted = drafted + torch.where(live, gamma, 0).sum()
        accepted = accepted + torch.where(live, a, torch.zeros_like(a)).sum()

    out = out[:, :max_new_budget]
    # The fused path's eos post-pass: out_len counts tokens up to and
    # including the first eos.
    is_eos = out == eos_id
    first_eos = torch.argmax(is_eos.int(), dim=1)
    final_len = torch.where(is_eos.any(dim=1),
                            torch.minimum(first_eos + 1, out_len), out_len)
    return SpecResult(tokens=out, out_len=final_len, rounds=rounds,
                      drafted=int(drafted), accepted=int(accepted))


def spec_tick(
    target_forward,  # (tokens [B, W], cache) -> (logits [B, W, V], cache)
    draft_forward,  # the same against the draft slot-pool cache
    prev: torch.Tensor,  # [B] last COMMITTED token (position L-1)
    cur: torch.Tensor,  # [B] pending token at position L (KV not written)
    tcache,  # target slot-pool cache, per-row length L
    dcache,  # draft slot-pool cache, per-row length L-1
    gamma: int,
    seeds: torch.Tensor,  # [B] per-row seeds
    step: int,  # unique per tick (the RNG stream tag)
    temps: Optional[torch.Tensor],  # [B] (0 = greedy); None = all greedy
    ks: torch.Tensor,  # [B]
    ps: torch.Tensor,  # [B]
    gstate: torch.Tensor,  # [B] grammar DFA state (0 = unconstrained)
    g_allow: torch.Tensor,  # [S, V] bool allow table
    g_trans: torch.Tensor,  # [S, V] int transition table
    j_len: Optional[torch.Tensor] = None,  # [S] forced-run lengths
    j_tokens: Optional[torch.Tensor] = None,  # [S, J] forced-run tokens
):
    """One fixed-shape draft / verify round over a continuous-batcher
    slot pool (the batching.speculative=on tick). The draft proposes
    gamma tokens (its first feed [prev, cur], prev rewriting its own
    slot: the draft cache stays one position behind the target), then
    the target verifies [cur, d_1..d_gamma] in one forward against the
    shared cache. Every row writes all gamma + 1 target positions; only
    the length pointers advance by the accepted count.

    Acceptance per row: temperature 0 — exact match against the target's
    grammar-masked argmax (the plain tick's tokens); temperature > 0 —
    rejection sampling over the temperature → top-k → top-p FILTERED p
    and q (`filtered_logprobs` filters both alike); constrained rows —
    the allow mask applies to every proposal and verify position, the
    DFA states advanced along the proposal path. With the forced-run
    tables, a proposal in a forced state takes the run's token from the
    table (the mask leaves it the only finite logit, so no emitted token
    changes). `temps` None (the host knows no row samples) skips every
    draw, as the greedy rows never read them.

    The caches are written in place. Returns (emit [B, gamma+1], count
    [B], prev', cur', gstate'): row i emits emit[i, :count[i]] (d_1..d_a,
    correction), count = a + 1."""
    tlen0, dlen0 = tcache.length, dcache.length
    dev = prev.device
    vocab = g_allow.shape[1]
    sampled = None if temps is None else temps > 0.0
    if sampled is not None:
        keys = fold_in(prng_key(seeds), step)
    gstate = gstate.long()
    neg = torch.tensor(-float("inf"), device=dev)

    def propose(logits, state, tag):
        """Grammar-masked proposal: a filtered-q Gumbel draw for sampled
        rows, the masked argmax for greedy ones. Returns (token [B],
        qlogp [B, V] or None)."""
        masked = torch.where(g_allow[state], logits.float(), neg)
        tok = torch.argmax(masked, -1)
        qlogp = None
        if sampled is not None:
            qlogp = filtered_logprobs(masked, temps, ks, ps)
            samp = torch.argmax(qlogp + gumbel(fold_in(keys, tag), vocab), -1)
            tok = torch.where(sampled, samp, tok)
        if j_len is not None:
            tok = torch.where(j_len[state] > 0, j_tokens[state, 0].long(), tok)
        return tok, qlogp

    def advance(state, tok):
        return g_trans[state, tok].long()

    # --- the draft proposes gamma tokens ---------------------------------
    dlogits, _ = draft_forward(torch.stack([prev, cur], dim=1).long(), dcache)
    tok, q = propose(dlogits[:, -1], gstate, 1)
    props, qs, states = [tok], [q], [gstate]
    state = advance(gstate, tok)
    for j in range(1, gamma):
        states.append(state)
        lg, _ = draft_forward(tok[:, None], dcache)
        tok, q = propose(lg[:, -1], state, 1 + j)
        props.append(tok)
        qs.append(q)
        state = advance(state, tok)
    states.append(state)
    proposals = torch.stack(props, dim=1)  # [B, gamma]
    # states[:, j] = the DFA state before verify position j.
    states = torch.stack(states, dim=1)  # [B, gamma + 1]

    # --- the target verifies in one (gamma+1)-position forward -------------
    verify_in = torch.cat([cur[:, None].long(), proposals], dim=1)
    vlogits, _ = target_forward(verify_in, tcache)  # [B, gamma + 1, V]
    vmask = g_allow[states]
    vmasked = torch.where(vmask, vlogits.float(), neg)
    tgt_greedy = torch.argmax(vmasked, -1)
    match = proposals == tgt_greedy[:, :gamma]
    if sampled is not None:
        w = gamma + 1
        plogp = filtered_logprobs(
            vmasked.reshape(-1, vocab), temps.repeat_interleave(w),
            ks.repeat_interleave(w), ps.repeat_interleave(w),
        ).reshape(vmasked.shape)
        qlogp = torch.stack(qs, dim=1)  # [B, gamma, V]
        u = uniform(fold_in(keys, 700), gamma)
        logp_x = torch.gather(plogp[:, :gamma], 2, proposals[..., None])[..., 0]
        logq_x = torch.gather(qlogp, 2, proposals[..., None])[..., 0]
        match = torch.where(sampled[:, None], torch.log(u) < logp_x - logq_x,
                            match)
    a = torch.cumprod(match.long(), dim=1).sum(dim=1)  # [B] in [0, gamma]

    # The correction at position a: the masked argmax for greedy rows;
    # for sampled rows normalize(max(p - q, 0)) (p itself after a full
    # acceptance), inside the filtered and masked support.
    correction = _gather(tgt_greedy, a)
    if sampled is not None:
        p_a = torch.exp(_gather(plogp, a))
        q_a = torch.exp(_gather(qlogp, torch.clamp(a, max=gamma - 1)))
        resid = torch.clamp(p_a - q_a, min=0.0)
        resid = torch.where((a == gamma)[:, None], p_a, resid)
        resid = torch.where(_gather(vmask, a), resid, torch.zeros_like(resid))
        # Roundoff guard: a numerically all-zero residual (p == q to
        # float precision at a rejected position) falls back to p, so
        # the argmax never lands on a zero-mass or disallowed token.
        resid = torch.where(resid.sum(-1, keepdim=True) > 1e-12, resid, p_a)
        g2 = gumbel(fold_in(keys, 900), vocab)
        corr = torch.argmax(torch.log(resid + 1e-30) + g2, -1)
        correction = torch.where(sampled, corr, correction)

    # --- emit [d_1..d_a, correction]; pointer-advance both caches ----------
    tcache.length = (tlen0 + 1 + a).to(torch.int32)
    dcache.length = (dlen0 + 1 + a).to(torch.int32)
    prev2 = _prev_after(proposals, a, cur)
    gstate2 = advance(_gather(states, a), correction)
    return _emit(proposals, a, correction), a + 1, prev2, correction, gstate2
