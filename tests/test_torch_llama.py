"""Model parity: the PyTorch port's Llama forward against the
reference's, on tiny-llama and tiny-mistral in float32, with the same
weights (the JAX init tree crossed through
`ggrmcp_tpu_torch.models.convert.params_from_numpy`).

Tolerance: logits agree within atol 2e-4 (rtol 0) in float32. Both
sides compute in float32; CPU matmuls in XLA and in PyTorch sum in a
different order, and the difference grows through four layers and the
vocab projection. Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu_torch.models import common as tcommon
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import rope as trope
from tests import torch_threads  # noqa: F401

ATOL = 2e-4
CPU = torch.device("cpu")


def _pair(name: str, **overrides):
    jcfg = dataclasses.replace(jl.CONFIGS[name], **overrides)
    tcfg = dataclasses.replace(tl.CONFIGS[name], **overrides)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-mistral"])
def models(request):
    return _pair(request.param)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(3, 512, (b, s)).astype(np.int32)


def _close(jlog, tlog):
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(
        tlog.numpy().argmax(-1), np.asarray(jlog).argmax(-1)
    )


def test_configs_match_reference():
    assert set(tl.CONFIGS) == set(jl.CONFIGS)
    for name, cfg in jl.CONFIGS.items():
        assert dataclasses.asdict(tl.CONFIGS[name]) == dataclasses.asdict(cfg)
        assert tl.num_params(tl.CONFIGS[name]) == jl.num_params(cfg)


def test_param_tree_crosses_unchanged(models):
    jcfg, jparams, _, tparams = models
    for key in ("embed", "lm_head", "final_norm"):
        assert tuple(tparams[key].shape) == jparams[key].shape
    for key, leaf in jparams["layers"].items():
        assert tuple(tparams["layers"][key].shape) == leaf.shape
    assert tcommon.count_params(tparams) == jl.num_params(jcfg)


def test_cache_free_forward(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, 2, 48)
    jlog, _ = jl.forward(jparams, jcfg, jnp.asarray(toks))
    tlog, _ = tl.forward(tparams, tcfg, torch.from_numpy(toks))
    _close(jlog, tlog)


def test_prefill_into_cache_then_16_decode_steps(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(2, 2, 40)
    jc = jl.KVCache.create(jcfg, 2, 64)
    tc = tl.KVCache.create(tcfg, 2, 64, CPU)
    jlog, jc = jl.forward(jparams, jcfg, jnp.asarray(toks[:, :24]), jc)
    tlog, tc = tl.forward(tparams, tcfg, torch.from_numpy(toks[:, :24]), tc)
    _close(jlog, tlog)
    # Greedy decode from each side's own argmax: tokens must agree step
    # for step, logits within tolerance.
    jcur = np.asarray(jlog)[:, -1].argmax(-1)
    tcur = tlog[:, -1].argmax(-1).numpy()
    for _ in range(16):
        np.testing.assert_array_equal(tcur, jcur)
        jlog, jc = jl.forward(
            jparams, jcfg, jnp.asarray(jcur[:, None].astype(np.int32)), jc
        )
        tlog, tc = tl.forward(
            tparams, tcfg, torch.from_numpy(tcur[:, None]), tc
        )
        _close(jlog, tlog)
        jcur = np.asarray(jlog)[:, -1].argmax(-1)
        tcur = tlog[:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_cached_prefill_with_offsets(models):
    """A chunk appended at per-row cache lengths (the chunked-admission
    shape) matches the reference."""
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(3, 2, 32)
    jc = jl.KVCache.create(jcfg, 2, 96)
    tc = tl.KVCache.create(tcfg, 2, 96, CPU)
    for lo in (0, 16):
        chunk = toks[:, lo:lo + 16]
        jlog, jc = jl.forward(jparams, jcfg, jnp.asarray(chunk), jc)
        tlog, tc = tl.forward(tparams, tcfg, torch.from_numpy(chunk), tc)
        _close(jlog, tlog)


def test_writes_past_cache_end_go_to_scratch():
    """A step whose positions run past S_max lands in the scratch slot
    (the reference's jit drops such writes) and leaves the cache proper
    untouched."""
    _, _, tcfg, tparams = _pair("tiny-llama")
    tc = tl.KVCache.create(tcfg, 1, 8, CPU)
    tl.forward(tparams, tcfg, torch.from_numpy(_tokens(4, 1, 6)), tc)
    before = tc.k[:, :, :8].clone()
    logits, tc = tl.forward(
        tparams, tcfg, torch.from_numpy(_tokens(5, 1, 4)), tc
    )
    assert torch.isfinite(logits).all()
    assert torch.equal(tc.k[:, :, :6], before[:, :, :6])
    assert int(tc.length[0]) == 10


def test_rope_scaling_tuple_matches():
    scaling = (8.0, 1.0, 4.0, 64)
    jcfg, jparams, tcfg, tparams = _pair("tiny-llama", rope_scaling=scaling)
    np.testing.assert_allclose(
        trope.rope_freqs(32, 10000.0, scaling).numpy(),
        np.asarray(
            __import__("ggrmcp_tpu.ops.rope", fromlist=["rope_freqs"])
            .rope_freqs(32, 10000.0, scaling)
        ),
        rtol=1e-6,
    )
    toks = _tokens(6, 2, 48)
    jlog, _ = jl.forward(jparams, jcfg, jnp.asarray(toks))
    tlog, _ = tl.forward(tparams, tcfg, torch.from_numpy(toks))
    _close(jlog, tlog)


def test_rms_norm_cast_order_bf16():
    """normalize in float32 → cast to the input dtype → multiply."""
    from ggrmcp_tpu.models.common import rms_norm as jrms

    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    ref = jrms(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    out = tcommon.rms_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    )


def test_random_init_is_seeded():
    cfg = tl.CONFIGS["tiny-llama"]
    a = tl.init_params(cfg, CPU, seed=3)
    b = tl.init_params(cfg, CPU, seed=3)
    c = tl.init_params(cfg, CPU, seed=4)
    assert torch.equal(a["layers"]["wqkv"], b["layers"]["wqkv"])
    assert not torch.equal(a["layers"]["wqkv"], c["layers"]["wqkv"])
    # Truncated at ±2σ with the fan-in scale.
    assert a["layers"]["wqkv"].abs().max() <= 2.0 * cfg.hidden_dim ** -0.5
