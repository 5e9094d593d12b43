"""Sampling parity: the PyTorch port's sampling against the reference's
`ggrmcp_tpu/ops/sampling.py`.

Greedy picks and the support mask must be identical. The port's
threefry uniforms must equal `jax.random`'s bit for bit, so sampled
tokens of `sample` and `sample_dynamic` are identical draw for draw;
`_invcdf_pick` is also held to the reference on shared numpy uniforms.
`filtered_logprobs` agrees within 1e-6 and `forced_run_lookup` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.ops import sampling as js
from ggrmcp_tpu_torch.ops import sampling as ts
from tests import torch_threads  # noqa: F401

V = 300


def _logits(seed, b=6):
    return np.random.default_rng(seed).standard_normal((b, V)).astype(
        np.float32
    ) * 3.0


ROW_PARAMS = (
    np.array([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], np.float32),  # temperature
    np.array([0, 0, 5, 40, 0, 1], np.int32),  # top_k
    np.array([1.0, 0.9, 1.0, 0.8, 0.5, 1.0], np.float32),  # top_p
)


def test_greedy_identical():
    logits = _logits(0)
    ref = np.asarray(js.sample(jnp.asarray(logits), None,
                               js.SamplingConfig()))
    out = ts.sample(torch.from_numpy(logits), 0, 0, ts.SamplingConfig())
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dynamic_support_mask_identical(seed):
    logits = _logits(seed)
    temp, k, p = ROW_PARAMS
    ref = js.dynamic_support_mask(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(k),
        jnp.asarray(p),
    )
    out = ts.dynamic_support_mask(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(k), torch.from_numpy(p),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_invcdf_pick_identical_from_shared_uniforms(seed):
    """The dynamic path's filtered logits, then the pick from the same
    uniforms on both sides."""
    logits = _logits(seed)
    temp, k, p = ROW_PARAMS
    u = np.random.default_rng(seed + 100).random(logits.shape[0]).astype(
        np.float32
    )
    j_support = js.dynamic_support_mask(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(k),
        jnp.asarray(p),
    )
    j_scaled = jnp.where(
        j_support, jnp.asarray(logits) / jnp.maximum(temp, 1e-6)[:, None],
        -jnp.inf,
    )
    ref = np.asarray(js._invcdf_pick(jnp.asarray(u), j_scaled))
    t_support = ts.dynamic_support_mask(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(k), torch.from_numpy(p),
    )
    t_scaled = torch.where(
        t_support,
        torch.from_numpy(logits)
        / torch.clamp(torch.from_numpy(temp), min=1e-6)[:, None],
        torch.tensor(-float("inf")),
    )
    out = ts._invcdf_pick(torch.from_numpy(u), t_scaled)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert t_support.gather(1, out.long()[:, None]).all()


@pytest.mark.parametrize(
    "cfg", [ts.SamplingConfig(0.8, 0, 1.0), ts.SamplingConfig(1.0, 7, 1.0),
            ts.SamplingConfig(1.2, 0, 0.7), ts.SamplingConfig(0.9, 20, 0.8)],
)
def test_static_filters_pick_identical_from_shared_uniforms(cfg):
    logits = _logits(9)
    u = np.random.default_rng(19).random(logits.shape[0]).astype(np.float32)
    jl = jnp.asarray(logits) / cfg.temperature
    tl = torch.from_numpy(logits) / cfg.temperature
    if cfg.top_k:
        jl, tl = js._mask_top_k(jl, cfg.top_k), ts._mask_top_k(tl, cfg.top_k)
    if cfg.top_p < 1.0:
        jl, tl = js._mask_top_p(jl, cfg.top_p), ts._mask_top_p(tl, cfg.top_p)
    np.testing.assert_array_equal(np.isinf(tl.numpy()), np.isinf(np.asarray(jl)))
    np.testing.assert_array_equal(
        ts._invcdf_pick(torch.from_numpy(u), tl).numpy(),
        np.asarray(js._invcdf_pick(jnp.asarray(u), jl)),
    )


def test_sample_dynamic_greedy_rows_and_support():
    logits = torch.from_numpy(_logits(11))
    temp, k, p = (torch.from_numpy(a) for a in ROW_PARAMS)
    seeds = torch.arange(6)
    out = ts.sample_dynamic(logits, seeds, 3, temp, k, p)
    assert int(out[0]) == int(logits[0].argmax())
    support = ts.dynamic_support_mask(logits, temp, k, p)
    assert support.gather(1, out.long()[:, None]).all()
    # Deterministic per (seed, step); the step moves the draw.
    again = ts.sample_dynamic(logits, seeds, 3, temp, k, p)
    assert torch.equal(out, again)


def test_masked_sample_state_zero_passes_through():
    logits = torch.from_numpy(_logits(12))
    temp, k, p = (torch.from_numpy(a) for a in ROW_PARAMS)
    allow, trans = ts.trivial_grammar_tables(V, torch.device("cpu"))
    state = torch.zeros(6, dtype=torch.int64)
    toks, nxt = ts.masked_sample_dynamic(
        logits, torch.arange(6), 5, temp, k, p, state, allow, trans
    )
    assert torch.equal(toks, ts.sample_dynamic(
        logits, torch.arange(6), 5, temp, k, p))
    assert not nxt.any()


SEEDS = [0, 1, 2**31 - 1, 2**32 - 1,
         int(np.random.default_rng(2024).integers(0, 2**32))]


@pytest.mark.parametrize("step", [0, 1, 9, 10**6])
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_uniform_bit_identical(seed, step):
    """uniform(fold_in(prng_key(seed), step)) is the reference batcher's
    per-row draw (uint32 seeds) bit for bit."""
    ref = jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), step), ())
    out = ts.uniform(ts.fold_in(ts.prng_key(torch.tensor([seed])), step))
    assert out.dtype == torch.float32 and 0.0 <= float(out[0]) < 1.0
    assert out.numpy().view(np.uint32)[0] == np.asarray(ref).view(np.uint32)


def test_threefry_row_fold_bit_identical():
    """The static path's per-row keys: fold_in(step key, row)."""
    key = jax.random.fold_in(jax.random.PRNGKey(77), 5)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(64))
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    out = ts.uniform(ts.fold_in(ts.fold_in(ts.prng_key(torch.tensor(77)), 5),
                                torch.arange(64)))
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    assert len(set(out.tolist())) == 64


@pytest.mark.parametrize("step", [0, 3, 1000])
@pytest.mark.parametrize(
    "cfg", [ts.SamplingConfig(0.8, 0, 1.0), ts.SamplingConfig(1.0, 7, 1.0),
            ts.SamplingConfig(1.2, 0, 0.7), ts.SamplingConfig(0.9, 20, 0.8)],
    ids=["temperature", "top_k", "top_p", "top_k_top_p"],
)
def test_sample_draws_match_reference(cfg, step):
    """The engine's static path: key fold_in(PRNGKey(seed), step), rows
    folded in, tokens identical draw for draw."""
    logits = _logits(30 + step, b=16)
    key = jax.random.fold_in(jax.random.PRNGKey(42), step)
    ref = np.asarray(js.sample(jnp.asarray(logits), key,
                               js.SamplingConfig(*cfg)))
    out = ts.sample(torch.from_numpy(logits), 42, step, cfg)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("step", [1, 10, 123457])
def test_sample_dynamic_draws_match_reference(step):
    """The batcher's per-row path on greedy, temperature, top-k and
    top-p rows, uint32 seeds as the reference batcher keeps them."""
    logits = _logits(40 + step)
    temp, k, p = ROW_PARAMS
    seeds = np.array([5, 2**32 - 1, 0, 77, 2**31 + 3, 9], np.uint32)
    ref = np.asarray(js.sample_dynamic(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.int32(step),
        jnp.asarray(temp), jnp.asarray(k), jnp.asarray(p)))
    out = ts.sample_dynamic(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        step, torch.from_numpy(temp), torch.from_numpy(k),
        torch.from_numpy(p))
    np.testing.assert_array_equal(out.numpy(), ref)


def _grammar_tables(seed, states=5):
    rng = np.random.default_rng(seed)
    allow = rng.random((states, V)) < 0.3
    allow[0] = True
    trans = rng.integers(0, states, (states, V)).astype(np.int32)
    return allow, trans


def test_masked_sample_dynamic_matches_reference():
    logits = _logits(50)
    temp, k, p = ROW_PARAMS
    allow, trans = _grammar_tables(51)
    state = np.array([0, 1, 2, 3, 4, 1], np.int32)
    seeds = np.arange(6, dtype=np.uint32) * 1000
    ref_tok, ref_next = js.masked_sample_dynamic(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.int32(7),
        jnp.asarray(temp), jnp.asarray(k), jnp.asarray(p),
        jnp.asarray(state), jnp.asarray(allow), jnp.asarray(trans))
    tok, nxt = ts.masked_sample_dynamic(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        7, torch.from_numpy(temp), torch.from_numpy(k), torch.from_numpy(p),
        torch.from_numpy(state), torch.from_numpy(allow),
        torch.from_numpy(trans))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))
    assert allow[state, tok.numpy()].all()


def test_filtered_logprobs_match_reference():
    logits = _logits(60)
    logits[1, :40] = -np.inf  # a grammar-masked row
    temp, k, p = ROW_PARAMS
    ref = np.asarray(js.filtered_logprobs(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(k),
        jnp.asarray(p)))
    out = ts.filtered_logprobs(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(k), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-6, rtol=0)


def test_forced_run_lookup_matches_reference():
    rng = np.random.default_rng(70)
    s, j = 12, 8
    jump_len = rng.integers(0, j + 1, s).astype(np.int32)
    jump_len[0] = 0
    jump_tokens = rng.integers(3, 259, (s, j)).astype(np.int32)
    jump_states = rng.integers(0, s, (s, j)).astype(np.int32)
    state = np.array([0, 3, 5, 7, 11, 2, 9, 4], np.int32)
    jump_ok = np.array([True, True, False, True, True, True, False, True])
    ref = js.forced_run_lookup(*(jnp.asarray(a) for a in (
        state, jump_len, jump_tokens, jump_states, jump_ok)))
    out = ts.forced_run_lookup(*(torch.from_numpy(a) for a in (
        state, jump_len, jump_tokens, jump_states, jump_ok)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_masked_all_greedy_skips_draw_with_greedy_tokens():
    """`temperature` None (no row samples, known on the host) gives the
    tokens and next states of all-zero temperatures."""
    logits = torch.from_numpy(_logits(80))
    allow, trans = (torch.from_numpy(a) for a in _grammar_tables(81))
    state = torch.tensor([0, 1, 2, 3, 4, 2])
    _, k, p = (torch.from_numpy(a) for a in ROW_PARAMS)
    seeds = torch.arange(6)
    fast = ts.masked_sample_dynamic(logits, seeds, 3, None, k, p, state,
                                    allow, trans)
    full = ts.masked_sample_dynamic(logits, seeds, 3, torch.zeros(6), k, p,
                                    state, allow, trans)
    for a, b in zip(fast, full):
        assert torch.equal(a, b)
