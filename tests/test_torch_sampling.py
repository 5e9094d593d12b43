"""Sampling parity: the PyTorch port's sampling against the reference's
`ggrmcp_tpu/ops/sampling.py`.

Greedy picks and the support mask must be identical. Random draws
cannot match (the reference draws its per-row uniform with threefry,
the port with a counter hash), so `_invcdf_pick` on both sides is fed
the SAME numpy uniforms and must pick identical tokens under
temperature, top-k and top-p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.ops import sampling as js
from ggrmcp_tpu_torch.ops import sampling as ts

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


def test_counter_uniform_range_and_independence():
    seeds = torch.arange(4096)
    u = ts.counter_uniform(seeds, 0)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(u, ts.counter_uniform(seeds, 1))
    assert torch.equal(u, ts.counter_uniform(seeds, 0))
    rows = ts.counter_uniform(torch.zeros(64, dtype=torch.long), 0,
                              torch.arange(64))
    assert len(set(rows.tolist())) == 64
