"""Int8 parity: the PyTorch port's `ops/quant.py`, int8-weight forward,
int8 KV cache, engine and continuous batcher against the reference's
(`ggrmcp_tpu/ops/quant.py`, `tests/test_quant.py`,
`tests/test_kv_quant.py`), on tiny-llama and tiny-mistral with the same
weights (the JAX init tree crossed through `params_from_numpy`).

Tolerances:
- `quantize` and `quantize_model`: bitwise (values and scales), float32
  and bfloat16 inputs, ties included (both round half to even).
- `dequantize`, `matmul`, `embed_lookup` in float32: 1e-6 absolute (the
  operands are bitwise equal; only the product's summation order
  differs). In bfloat16: one bf16 step (2**-7 relative) of the output.
- int8-weight logits: 2e-4 absolute, as for dense weights
  (`tests/test_torch_llama.py`): the int8 weights are bitwise equal, so
  only float32 summation order differs.
- int8-KV logits: 1e-2 absolute. Each side quantizes its own float32
  K/V, which differ from the other side's in the last bits; where a
  value sits at a rounding tie of the int8 grid the two sides store
  neighbouring steps (|dq| = 1, about 1 in 3000 values here), which
  moves that key's scores by one scale step. The cache leaves are
  compared directly: every q within one step; scales within 1e-5
  relative in the first layer (float32 summation order only) and 1e-3
  above it (whose inputs carry the flips' effect). Greedy tokens must
  be identical.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core import config as jcfgmod
from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import common as jcommon
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops import quant as jq
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch import __main__ as cli
from ggrmcp_tpu_torch.core import config as tcfgmod
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.models import common as tcommon
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops import quant as tq
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine

CPU = torch.device("cpu")
ATOL_WEIGHTS = 2e-4
ATOL_KV = 1e-2
SMALL = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)
MATMULS = ("wqkv", "wo", "w_gate", "w_up", "w_down")


def _single_mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


def _copy(params):
    """A fresh dict tree over the same tensors: the port's engine
    quantizes the dict it is given in place."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-mistral"])
def models(request):
    name = request.param
    jcfg, tcfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jqp = jq.quantize_model(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, jqp, tcfg, tparams, tq.quantize_model(tparams)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(3, 512, (b, s)).astype(np.int32)


def _same_quant(ref, got, where=""):
    assert isinstance(got, tq.QuantizedTensor), where
    assert got.q.dtype == torch.int8, where
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q),
                                  err_msg=where)
    ref_scale = np.asarray(ref.scale).astype(np.float32)
    np.testing.assert_array_equal(got.scale.float().numpy(), ref_scale,
                                  err_msg=where)


# -- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bitwise(dtype, axis):
    """Seeded weights with an all-zero column and an all-zero row: the
    port's q and scale equal the reference's bit for bit; a bf16 input
    keeps its scale in bf16, rounded from the float32 scale q used."""
    w = np.random.default_rng(3).standard_normal((3, 64, 48)).astype(
        np.float32) * 0.05
    w[0, :, 5] = 0.0
    w[1, 7, :] = 0.0
    if dtype == "bfloat16":
        wb = w.astype(ml_dtypes.bfloat16)
        ref = jq.quantize(jnp.asarray(wb), axis=axis)
        got = tq.quantize(torch.from_numpy(wb.astype(np.float32)).bfloat16(),
                          axis=axis)
        assert got.scale.dtype == torch.bfloat16 and got.dtype == torch.bfloat16
    else:
        ref = jq.quantize(jnp.asarray(w), axis=axis)
        got = tq.quantize(torch.from_numpy(w), axis=axis)
    _same_quant(ref, got)
    expect = list(w.shape)
    expect[axis] = 1
    assert tuple(got.scale.shape) == tuple(expect)
    assert got.shape == torch.Size(w.shape)
    assert got.nbytes == w.size + got.scale.nbytes


def test_quantize_rounds_ties_to_even():
    """Values constructed at exact half-way points of the int8 grid
    (k + 0.5 steps, the column's max at 127 steps): both packages round
    half to even."""
    step = np.float32(1.0) / np.float32(127.0)
    w = np.zeros((6, 4), np.float32)
    w[0] = 1.0
    w[1:] = ((np.arange(5, dtype=np.float32)[:, None] + 0.5)
             * np.ones((1, 4), np.float32)) * step
    ref = jq.quantize(jnp.asarray(w))
    got = tq.quantize(torch.from_numpy(w))
    _same_quant(ref, got)
    assert got.q[1:, 0].tolist() == np.round(np.arange(5) + 0.5).tolist()


def test_dequantize_matmul_embed_match_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    tokens = np.array([[0, 3, 15], [2, 2, 9]], np.int32)
    jw, tw = jq.quantize(jnp.asarray(w)), tq.quantize(torch.from_numpy(w))
    jt = jq.quantize(jnp.asarray(table), axis=-1)
    tt = tq.quantize(torch.from_numpy(table), axis=-1)
    pairs = [
        (jq.dequantize(jw), tq.dequantize(tw)),
        (jq.matmul(jnp.asarray(x), jw), tq.matmul(torch.from_numpy(x), tw)),
        (jq.embed_lookup(jt, jnp.asarray(tokens), jnp.float32),
         tq.embed_lookup(tt, torch.from_numpy(tokens), torch.float32)),
        # Dense weights pass through.
        (jq.matmul(jnp.asarray(x), jnp.asarray(w)),
         tq.matmul(torch.from_numpy(x), torch.from_numpy(w))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)


def test_bf16_matmul_and_embed_match_reference():
    """bf16 activations and bf16 scales: the cast, the product and the
    scale multiply round as the reference's do, within one bf16 step."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(ml_dtypes.bfloat16)
    x = rng.standard_normal((8, 128)).astype(ml_dtypes.bfloat16)
    jw = jq.quantize(jnp.asarray(w))
    tw = tq.quantize(torch.from_numpy(w.astype(np.float32)).bfloat16())
    _same_quant(jw, tw)
    ref = np.asarray(jq.matmul(jnp.asarray(x), jw)).astype(np.float32)
    got = tq.matmul(torch.from_numpy(x.astype(np.float32)).bfloat16(), tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)
    jt = jq.quantize(jnp.asarray(w), axis=-1)
    tt = tq.quantize(torch.from_numpy(w.astype(np.float32)).bfloat16(),
                     axis=-1)
    tokens = np.array([[1, 127, 5]], np.int32)
    ref = np.asarray(jq.embed_lookup(jt, jnp.asarray(tokens), jnp.bfloat16))
    got = tq.embed_lookup(tt, torch.from_numpy(tokens), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


def test_kv_map_applies_to_both_leaves():
    qt = tq.quantize(torch.randn(2, 5, 3, 4), axis=-1)
    head = tq.kv_map(lambda t: t[:, :2], qt)
    assert isinstance(head, tq.QuantizedTensor)
    assert torch.equal(head.q, qt.q[:, :2])
    assert torch.equal(head.scale, qt.scale[:, :2])
    dense = torch.randn(2, 5)
    assert torch.equal(tq.kv_map(lambda t: t * 2, dense), dense * 2)
    with pytest.raises(TypeError):
        _ = qt[0]  # a quantized leaf is not a tuple


# -- whole-model transforms -----------------------------------------------------


def test_quantize_model_matches_reference(models):
    jcfg, jparams, jqp, _, tparams, tqp = models
    for name in MATMULS:
        _same_quant(jqp["layers"][name], tqp["layers"][name], name)
    for name in ("embed", "lm_head"):
        _same_quant(jqp[name], tqp[name], name)
    for name in ("attn_norm", "mlp_norm"):
        assert not isinstance(tqp["layers"][name], tq.QuantizedTensor)
        assert torch.equal(tqp["layers"][name], tparams["layers"][name])
    assert torch.equal(tqp["final_norm"], tparams["final_norm"])
    # The input tree is left dense.
    assert not isinstance(tparams["layers"]["wqkv"], tq.QuantizedTensor)
    assert tq.quantized_nbytes(tqp) == jq.quantized_nbytes(jqp)
    assert tq.quantized_nbytes(tqp) < 0.5 * tq.quantized_nbytes(tparams)
    # Parameter counts include the scales, as the reference's pytree
    # leaves do (GetModelInfo.num_params_million).
    assert tcommon.count_params(tqp) == jcommon.count_params(jqp)
    assert tcommon.param_bytes(tqp) == jq.quantized_nbytes(jqp)


def test_only_stacked_matmuls_quantize():
    """A leaf under a matmul name that is not 3-D (the reference's MoE
    expert banks are 4-D) stays dense."""
    params = {"layers": {"wqkv": torch.randn(2, 8, 12),
                         "w_gate": torch.randn(2, 3, 8, 12),
                         "attn_norm": torch.ones(2, 8)}}
    out = tq.quantize_model(params)
    assert isinstance(out["layers"]["wqkv"], tq.QuantizedTensor)
    assert out["layers"]["w_gate"] is params["layers"]["w_gate"]
    assert out["layers"]["attn_norm"] is params["layers"]["attn_norm"]


def test_params_from_numpy_carries_quantized_tree(models):
    _, _, jqp, _, _, tqp = models
    crossed = params_from_numpy(jax.tree.map(np.asarray, jqp), CPU)
    for name in MATMULS:
        leaf = crossed["layers"][name]
        assert isinstance(leaf, tq.QuantizedTensor)
        assert leaf.q.dtype == torch.int8
        assert torch.equal(leaf.q, tqp["layers"][name].q)
        assert torch.equal(leaf.scale, tqp["layers"][name].scale)
    assert isinstance(crossed["embed"], tq.QuantizedTensor)
    assert not isinstance(crossed["final_norm"], tq.QuantizedTensor)


# -- the forward ----------------------------------------------------------------


def _close(jlog, tlog, atol):
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(
        tlog.numpy().argmax(-1), np.asarray(jlog).argmax(-1)
    )


def test_quantized_forward_matches_reference(models):
    """int8 weights, cache-free, then prefill and 8 greedy decode steps
    through a dense cache."""
    jcfg, _, jqp, tcfg, _, tqp = models
    toks = _tokens(1, 2, 48)
    jlog, _ = jl.forward(jqp, jcfg, jnp.asarray(toks))
    tlog, _ = tl.forward(tqp, tcfg, torch.from_numpy(toks))
    _close(jlog, tlog, ATOL_WEIGHTS)
    jc = jl.KVCache.create(jcfg, 2, 64)
    tc = tl.KVCache.create(tcfg, 2, 64, CPU)
    jlog, jc = jl.forward(jqp, jcfg, jnp.asarray(toks[:, :24]), jc)
    tlog, tc = tl.forward(tqp, tcfg, torch.from_numpy(toks[:, :24]), tc)
    _close(jlog, tlog, ATOL_WEIGHTS)
    for _ in range(8):
        cur = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
        jlog, jc = jl.forward(jqp, jcfg, jnp.asarray(cur), jc)
        tlog, tc = tl.forward(tqp, tcfg, torch.from_numpy(cur), tc)
        _close(jlog, tlog, ATOL_WEIGHTS)


def test_kv_cache_int8_layout():
    cfg = tl.CONFIGS["tiny-llama"]
    cache = tl.KVCache.create(cfg, 3, 16, CPU, "int8")
    for leaf in (cache.k, cache.v):
        assert isinstance(leaf, tq.QuantizedTensor)
        assert leaf.q.shape == (4, 3, 17, 4, 32) and leaf.q.dtype == torch.int8
        assert leaf.scale.shape == (4, 3, 17, 4, 1)
        assert leaf.scale.dtype == cfg.torch_dtype
    assert cache.capacity == 16
    dense = tl.KVCache.create(cfg, 3, 16, CPU)
    assert cache.nbytes() == (2 * (4 * 3 * 17 * 4 * 32 + 4 * 3 * 17 * 4 * 4)
                              + 3 * 4)
    assert cache.k.nbytes < 0.6 * dense.k.nbytes
    with pytest.raises(ValueError, match="int4"):
        tl.KVCache.create(cfg, 1, 8, CPU, "int4")
    with pytest.raises(ValueError):
        jl.KVCache.create(jl.CONFIGS["tiny-llama"], 1, 8, "int4")


def _kv_leaves_close(jleaf, tleaf, cap):
    """The int8 cache leaves themselves: every stored value within one
    int8 step of the reference's (few differ at all), every scale close
    (first layer 1e-5, the others 1e-3 relative), written at the same
    positions."""
    jqv = np.asarray(jleaf.q).astype(np.int32)
    tqv = tleaf.q[:, :, :cap].numpy().astype(np.int32)
    diff = np.abs(jqv - tqv)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3, (diff > 0).mean()
    ref_scale = np.asarray(jleaf.scale)
    scale = tleaf.scale[:, :, :cap].numpy()
    np.testing.assert_allclose(scale[0], ref_scale[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(scale, ref_scale, rtol=1e-3, atol=0)
    # Unwritten positions hold zeros on both sides.
    assert ((np.asarray(jleaf.scale) == 0) ==
            (tleaf.scale[:, :, :cap].numpy() == 0)).all()


def test_int8_kv_matches_reference(models):
    """Prefill, a chunk at per-row offsets, then 10 greedy decode steps
    through an int8 cache on both sides (int8 weights too)."""
    jcfg, _, jqp, tcfg, _, tqp = models
    toks = _tokens(2, 2, 40)
    jc = jl.KVCache.create(jcfg, 2, 64, "int8")
    tc = tl.KVCache.create(tcfg, 2, 64, CPU, "int8")
    for lo, hi in ((0, 16), (16, 28)):
        jlog, jc = jl.forward(jqp, jcfg, jnp.asarray(toks[:, lo:hi]), jc)
        tlog, tc = tl.forward(tqp, tcfg, torch.from_numpy(toks[:, lo:hi]), tc)
        _close(jlog, tlog, ATOL_KV)
    for _ in range(10):
        cur = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
        jlog, jc = jl.forward(jqp, jcfg, jnp.asarray(cur), jc)
        tlog, tc = tl.forward(tqp, tcfg, torch.from_numpy(cur), tc)
        _close(jlog, tlog, ATOL_KV)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    _kv_leaves_close(jc.k, tc.k, 64)
    _kv_leaves_close(jc.v, tc.v, 64)


def test_int8_kv_close_to_dense_cache():
    """The reference's own bound (tests/test_kv_quant.py): prefill and a
    decode step through an int8 cache against the dense cache on the
    same weights, within 5 % of the largest logit."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, CPU, seed=0)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(1, 500, (2, 24)))
    step = torch.from_numpy(np.random.RandomState(1).randint(1, 500, (2, 1)))
    outs = {}
    for kv_dtype in ("", "int8"):
        cache = tl.KVCache.create(cfg, 2, 64, CPU, kv_dtype)
        logits_p, cache = tl.forward(params, cfg, tokens, cache)
        logits_d, _ = tl.forward(params, cfg, step, cache)
        outs[kv_dtype] = (logits_p, logits_d)
    for a, b in zip(outs[""], outs["int8"]):
        assert (a - b).abs().max() / a.abs().max().clamp_min(1e-6) < 0.05


def test_int8_kv_writes_past_end_go_to_scratch(models):
    """Values and scales of a step past S_max land in the scratch slot
    of both leaves; the cache proper is untouched."""
    _, _, _, tcfg, _, tqp = models
    tc = tl.KVCache.create(tcfg, 1, 8, CPU, "int8")
    tl.forward(tqp, tcfg, torch.from_numpy(_tokens(4, 1, 6)), tc)
    before = (tc.k.q[:, :, :6].clone(), tc.k.scale[:, :, :6].clone())
    logits, tc = tl.forward(tqp, tcfg, torch.from_numpy(_tokens(5, 1, 4)), tc)
    assert torch.isfinite(logits).all()
    assert torch.equal(tc.k.q[:, :, :6], before[0])
    assert torch.equal(tc.k.scale[:, :, :6], before[1])
    assert (tc.k.scale[:, :, 6:] != 0).all()  # positions 6, 7 and scratch
    assert int(tc.length[0]) == 10


# -- engine and batcher ---------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(0)
    # Short prompts take fused admission; 30 and 41 tokens exceed the
    # 16-token prefill_chunk and take chunked admission.
    return [rng.integers(3, 500, n).tolist() for n in (5, 12, 30, 9, 41, 16)]


@pytest.fixture(scope="module")
def tiny_weights():
    cfg = jl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module", params=["", "int8"], ids=["bf16kv", "int8kv"])
def int8_engines(request, tiny_weights):
    jparams, tparams = tiny_weights
    kv = request.param
    jeng = JEngine(
        jl.CONFIGS["tiny-llama"],
        JServing(mesh=MeshConfig(tensor=1), quantize="int8",
                 kv_cache_dtype=kv),
        # A copy: the reference engine donates the dense tree it quantizes.
        mesh=_single_mesh(), params=jax.tree.map(jnp.array, jparams),
    )
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"],
        ServingConfig(quantize="int8", kv_cache_dtype=kv),
        params=_copy(tparams), device="cpu",
    )
    return kv, jeng, teng


def test_engine_quantizes_like_reference(int8_engines):
    """The engines' int8 weights: q bitwise equal. The reference engine
    quantizes under jit, where XLA computes `amax / 127` as `amax *
    (1/127)`, so its stored float32 scales differ from its own eager
    `quantize` (and from the port, which is bitwise that) by one ulp in
    some columns; the scales are held to one ulp (2**-23 relative)."""
    _, jeng, teng = int8_engines
    jqp = jeng.params
    for name in (*MATMULS, "embed", "lm_head"):
        ref = jqp["layers"][name] if name in MATMULS else jqp[name]
        got = teng.params["layers"][name] if name in MATMULS else \
            teng.params[name]
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q),
                                      err_msg=name)
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                                   rtol=2 ** -23, atol=0, err_msg=name)
    assert teng.weight_bytes() == jq.quantized_nbytes(jqp)
    info = teng.model_info()
    assert info["num_params_million"] == jeng.model_info()["num_params_million"]
    assert info["dtype"] == "float32"


def test_engine_int8_generate_matches_reference(int8_engines):
    kv, jeng, teng = int8_engines
    prompts = _prompts()[:3]
    ref, ref_reasons = jeng.generate(prompts, max_new_tokens=10)
    out, reasons = teng.generate(prompts, max_new_tokens=10)
    assert out == ref and reasons == ref_reasons
    assert list(teng.generate_stream(prompts[2], max_new_tokens=10)) == ref[2]
    assert teng.use_flash is (False if kv else None)
    assert jeng.use_flash is teng.use_flash
    assert teng.kv_dtype == kv


async def _run_all(batcher, prompts, max_new, sampling):
    async def one(prompt, seed):
        out = []
        async for ids, _ in batcher.submit(prompt, max_new, sampling,
                                           seed=seed):
            out.extend(ids)
        return out

    batcher.start()
    try:
        return await asyncio.gather(
            *(one(p, i) for i, p in enumerate(prompts))
        )
    finally:
        await batcher.stop()


async def test_batcher_int8_matches_reference_both_routes(int8_engines):
    kv, jeng, teng = int8_engines
    prompts = _prompts()
    ref = await _run_all(JBatcher(jeng, JBatching(**SMALL)), prompts, 7,
                         JSampling(temperature=0.0))
    port = ContinuousBatcher(teng, BatchingConfig(**SMALL))
    out = await _run_all(port, prompts, 7, SamplingConfig(temperature=0.0))
    assert out == ref
    assert port.fused_admissions > 0 and port.chunked_admissions > 0
    stats = port.stats()
    cache = port.cache
    assert isinstance(cache.k, tq.QuantizedTensor) == bool(kv)
    assert stats["kv_cache_bytes"] == cache.k.nbytes + cache.v.nbytes
    if kv:
        # The scales count: 4 layers x 4 slots x 257 x 4 heads x (32 int8
        # values + one float32 scale), for K and for V.
        assert stats["kv_cache_bytes"] == 2 * 4 * 4 * 257 * 4 * (32 + 4)
    assert stats["memory_weights_bytes"] == jq.quantized_nbytes(jeng.params)


async def test_batcher_int8_kv_tick_failure_rebuilds_int8_cache(int8_engines):
    """A failed tick replays on a fresh cache of the engine's KV dtype and
    finishes with the tokens of an undisturbed run."""
    kv, _, teng = int8_engines
    prompts = _prompts()[:3]
    clean = await _run_all(ContinuousBatcher(teng, BatchingConfig(**SMALL)),
                           prompts, 6, SamplingConfig())
    batcher = ContinuousBatcher(teng, BatchingConfig(**SMALL))
    real_tick, calls = batcher._tick_impl, []

    def flaky_tick(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected tick failure")
        return real_tick(*args, **kwargs)

    batcher._tick_impl = flaky_tick
    out = await _run_all(batcher, prompts, 6, SamplingConfig())
    assert out == clean
    assert batcher.stats()["replayed_requests"] > 0
    assert isinstance(batcher.cache.k, tq.QuantizedTensor) == bool(kv)


def test_int8_kv_never_reaches_flash(tiny_weights, monkeypatch):
    """Under int8 KV every attention takes attention_ref, prefill
    included (prompts far above GQA_GROUPED_MAX_SQ); with a dense cache
    the same prompts do reach flash_attention."""
    _, tparams = tiny_weights
    calls = []

    def refuse(*args, **kwargs):
        calls.append(1)
        raise AssertionError("flash_attention reached on the int8 KV path")

    monkeypatch.setattr(tatt, "flash_attention", refuse)
    cfg = tl.CONFIGS["tiny-llama"]
    eng = GenerationEngine(cfg, ServingConfig(kv_cache_dtype="int8"),
                           params=tparams, device="cpu")
    assert eng.use_flash is False
    out, _ = eng.generate([list(range(3, 60)), list(range(5, 40))], 4)
    assert all(out) and not calls
    dense = GenerationEngine(cfg, params=tparams, device="cpu")
    with pytest.raises(AssertionError, match="int8 KV path"):
        dense.generate([list(range(3, 60))], 2)
    assert calls


def test_quantize_params_by_slice_is_bitwise_and_in_place():
    """The engine's layer-by-layer quantization equals whole-leaf
    `quantize` bit for bit (bf16 weights, bf16 scales), and replaces the
    dense leaves of the dict it was given."""
    cfg = dataclasses.replace(tl.CONFIGS["tiny-llama"], dtype="bfloat16")
    params = tl.init_params(cfg, CPU, seed=2)
    whole = tq.quantize_model(params)
    given = _copy(params)
    eng = GenerationEngine(cfg, ServingConfig(quantize="int8"),
                           params=given, device="cpu")
    assert eng.params is given
    for name in MATMULS:
        leaf = given["layers"][name]
        assert isinstance(leaf, tq.QuantizedTensor)
        assert leaf.scale.dtype == torch.bfloat16
        assert torch.equal(leaf.q, whole["layers"][name].q)
        assert torch.equal(leaf.scale, whole["layers"][name].scale)
    for name in ("embed", "lm_head"):
        assert torch.equal(given[name].q, whole[name].q)
        assert torch.equal(given[name].scale, whole[name].scale)


def test_unknown_quantize_mode_rejected_by_engine():
    serving = ServingConfig()
    serving.quantize = "fp4"  # past the config's own check
    with pytest.raises(ValueError, match="unknown quantize mode"):
        GenerationEngine(tl.CONFIGS["tiny-llama"], serving, device="cpu")


def test_synthetic_weights_never_densified(monkeypatch):
    """serving.synthetic_weights: the int8 structure drawn directly —
    neither the dense init nor `quantize` runs — seeded, and servable."""
    def refuse(*args, **kwargs):
        raise AssertionError("a dense weight was made")

    monkeypatch.setattr(tl, "init_params", refuse)
    monkeypatch.setattr(tq, "quantize", refuse)
    serving = ServingConfig(quantize="int8", synthetic_weights=True)
    cfg = tl.CONFIGS["tiny-llama"]
    eng = GenerationEngine(cfg, serving, seed=3, device="cpu")
    again = GenerationEngine(cfg, serving, seed=3, device="cpu")
    params = eng.params
    shapes = tl.param_shapes(cfg)
    for name in MATMULS:
        leaf = params["layers"][name]
        assert isinstance(leaf, tq.QuantizedTensor)
        assert tuple(leaf.shape) == shapes["layers"][name]
        assert leaf.q.dtype == torch.int8 and leaf.q.abs().max() <= 127
        assert leaf.scale.shape[-2] == 1 and (leaf.scale > 0).all()
        assert torch.equal(leaf.q, again.params["layers"][name].q)
    assert isinstance(params["lm_head"], tq.QuantizedTensor)
    assert params["embed"].scale.shape == (cfg.vocab_size, 1)
    norm = params["layers"]["attn_norm"]
    assert norm.dtype == torch.float32 and (norm >= 1e-3).all()
    out, reasons = eng.generate([[3, 1, 4, 1, 5]], max_new_tokens=6)
    assert len(out[0]) <= 6 and reasons[0] in ("length", "stop")


def test_param_shapes_match_init():
    cfg = tl.CONFIGS["tiny-mistral"]
    params = tl.init_params(cfg, CPU)
    shapes = tl.param_shapes(cfg)
    for key, value in params.items():
        if isinstance(value, dict):
            assert {n: tuple(t.shape) for n, t in value.items()} == shapes[key]
        else:
            assert tuple(value.shape) == shapes[key]


# -- config and CLI -------------------------------------------------------------


# (fields, raises): the reference's Config.validate cases of
# tests/test_kv_quant.py and tests/test_quant.py.
VALIDATION = [
    (dict(quantize="int8"), False),
    (dict(kv_cache_dtype="int8"), False),
    (dict(quantize="int8", kv_cache_dtype="int8"), False),
    (dict(quantize="fp4"), True),
    (dict(kv_cache_dtype="int4"), True),
    (dict(synthetic_weights=True), True),
    (dict(synthetic_weights=True, quantize="int8"), False),
    (dict(synthetic_weights=True, quantize="int8",
          hf_checkpoint_path="/ck"), True),
    (dict(synthetic_weights=True, quantize="int8",
          checkpoint_path="/ck"), True),
]


@pytest.mark.parametrize("fields,raises", VALIDATION,
                         ids=[str(i) for i in range(len(VALIDATION))])
def test_config_validation_matches_reference(fields, raises):
    ref = jcfgmod.default()
    for key, value in fields.items():
        setattr(ref.serving, key, value)
    if raises:
        with pytest.raises(ValueError):
            ref.validate()
        with pytest.raises(ValueError):
            ServingConfig(**fields)
    else:
        ref.validate()
        cfg = ServingConfig(**fields)
        assert all(getattr(cfg, k) == v for k, v in fields.items())


def test_cli_quantize_and_config_parse(tmp_path):
    path = tmp_path / "serving.json"
    path.write_text(json.dumps({"serving": {
        "model": "tiny-mistral", "kv_cache_dtype": "int8",
        "quantize": "int8", "synthetic_weights": True, "port": 7,
        "batching": {"max_batch_size": 2, "kv_cache_max_seq": 128},
    }}))
    args = cli.build_parser().parse_args(
        ["sidecar", "--config", str(path), "--port", "9"])
    cfg = cli.serving_config(args)
    assert (cfg.model, cfg.kv_cache_dtype, cfg.quantize, cfg.port) == (
        "tiny-mistral", "int8", "int8", 9)
    assert cfg.synthetic_weights
    assert cfg.batching.max_batch_size == 2
    assert cfg.batching.kv_cache_max_seq == 128
    args = cli.build_parser().parse_args(["sidecar", "--quantize", "int8"])
    cfg = cli.serving_config(args)
    assert (cfg.quantize, cfg.model, cfg.port) == ("int8", "tiny-llama", 50051)
    assert cli.serving_config(
        cli.build_parser().parse_args(["sidecar"])) == ServingConfig()
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["sidecar", "--quantize", "int4"])


@pytest.mark.parametrize("data,match", [
    ({"model": "tiny-llama"}, "top-level"),
    ({"serving": {"modle": "tiny-llama"}}, "modle"),
    ({"serving": {"batching": {"max_batch": 2}}}, "max_batch"),
    ({"serving": {"kv_cache_dtype": "int4"}}, "kv_cache_dtype"),
    ({"serving": {"batching": {"paged_kv": "on"}}}, "paged_kv"),
], ids=["top_level", "serving_key", "batching_key", "bad_value", "guard"])
def test_config_file_refuses_unknown_keys(tmp_path, data, match):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=match):
        tcfgmod.load_serving_config(str(path))
