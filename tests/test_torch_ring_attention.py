"""Sequence-parallel attention in the port (the counterpart of
`tests/test_ring_attention.py`): `ops/ring_attention.py`'s ring and
Ulysses against the JAX package's on 2- and 4-device meshes
(`jax.devices()[:n]` of the suite's forced 8-device CPU platform; the
port's mesh is the CPU repeated n times), causal, non-causal and
windowed, float32, within 1e-5; the reference's refusals; the
`attn_impl` prefill hook against the local forward (1e-5); and the
engine and the batcher on a sequence mesh generating the JAX engine's
greedy tokens on the same weights (exact), with the int8 KV cache and
with tiny-mistral's sliding window. Weights cross from JAX through
numpy (`params_from_numpy`)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops import ring_attention as jring
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig, MeshConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import ring_attention as tring
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

ATOL = 1e-5
CPU = torch.device("cpu")
IMPLS = {"ring": (jring.ring_attention, tring.ring_attention),
         "ulysses": (jring.ulysses_attention, tring.ulysses_attention)}
PROMPT = [3 + (i * 7 % 490) for i in range(37)]  # buckets to 64


def _meshes(n):
    return (jmesh.build_mesh(JMesh(sequence=n, tensor=1, data=1),
                             jax.devices()[:n]),
            tmesh.build_mesh(MeshConfig(sequence=n, tensor=1), [CPU] * n))


def _qkv(b=2, s=32, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)],
                         ids=["causal", "non_causal", "window"])
def test_matches_reference(n, impl, causal, window):
    jm, tm = _meshes(n)
    jfn, tfn = IMPLS[impl]
    q, k, v = _qkv()
    want = np.asarray(jfn(*map(jnp.asarray, (q, k, v)), jm, causal=causal,
                          window=window))
    got = tfn(*map(torch.from_numpy, (q, k, v)), tm, causal=causal,
              window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_axis_of_one_is_plain_attention(impl):
    from ggrmcp_tpu_torch.ops.attention import attention_ref

    q, k, v = map(torch.from_numpy, _qkv())
    mesh = tmesh.build_mesh(MeshConfig(tensor=1), [CPU])
    got = IMPLS[impl][1](q, k, v, mesh, causal=True)
    assert torch.equal(got, attention_ref(q, k, v, causal=True))


@pytest.mark.parametrize("impl,shape,match", [
    ("ring", dict(s=30), "sequence length 30 not divisible by sequence "
     "axis 4"),
    ("ulysses", dict(s=30), "sequence 30 not divisible by sequence=4"),
    ("ulysses", dict(h=2), "head count 2 not divisible by sequence=4"),
])
def test_refusals_match_reference(impl, shape, match):
    jm, tm = _meshes(4)
    q, k, v = _qkv(**shape)
    with pytest.raises(ValueError, match=match):
        IMPLS[impl][0](*map(jnp.asarray, (q, k, v)), jm)
    with pytest.raises(ValueError, match=match):
        IMPLS[impl][1](*map(torch.from_numpy, (q, k, v)), tm)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_window_requires_causal(impl):
    jm, tm = _meshes(2)
    q, k, v = _qkv()
    with pytest.raises(AssertionError, match="sliding window requires causal"):
        IMPLS[impl][0](*map(jnp.asarray, (q, k, v)), jm, causal=False,
                       window=4)
    with pytest.raises(ValueError, match="sliding window requires causal"):
        IMPLS[impl][1](*map(torch.from_numpy, (q, k, v)), tm, causal=False,
                       window=4)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name in ("tiny-llama", "tiny-mistral"):
        jparams = jl.init_params(jax.random.PRNGKey(3), jl.CONFIGS[name])
        out[name] = (jparams, jax.tree.map(np.asarray, jparams))
    return out


def _jref(weights, name, **serving):
    """The JAX engine on one device: the local prefill path."""
    return JEngine(jl.CONFIGS[name], JServing(model=name, sp_prefill="",
                                              **serving),
                   mesh=jmesh.build_mesh(JMesh(tensor=1), jax.devices()[:1]),
                   params=weights[name][0])


def _sp_engine(weights, name, n=4, mode="ring", **serving):
    engine = GenerationEngine(
        tl.CONFIGS[name],
        ServingConfig(model=name, mesh=MeshConfig(sequence=n, tensor=1),
                      sp_prefill=mode, sp_prefill_min_seq=64, **serving),
        params=params_from_numpy(weights[name][1], CPU),
        mesh=tmesh.build_mesh(MeshConfig(sequence=n, tensor=1), [CPU] * n))
    assert engine.sp_prefill == mode
    # The engine counts the calls of its sequence-parallel attention.
    assert engine.sp_calls == 0
    return engine


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attn_impl_prefill_matches_local_forward(weights, mode):
    cfg = tl.CONFIGS["tiny-llama"]
    params = params_from_numpy(weights["tiny-llama"][1], CPU)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)))
    _, mesh = _meshes(4)
    impl = IMPLS[mode][1]
    ref_cache = tl.KVCache.create(cfg, 2, 64, CPU)
    sp_cache = tl.KVCache.create(cfg, 2, 64, CPU)
    want, ref_cache = tl.forward(params, cfg, tokens, ref_cache,
                                 use_flash=False)
    got, sp_cache = tl.forward(
        params, cfg, tokens, sp_cache,
        attn_impl=lambda q, k, v, causal=True, window=None: impl(
            q, k, v, mesh, causal=causal, window=window))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(sp_cache.k, ref_cache.k, atol=ATOL, rtol=ATOL)
    assert torch.equal(sp_cache.length, ref_cache.length)


@pytest.mark.parametrize("name,mode,serving", [
    ("tiny-llama", "ring", {}),
    ("tiny-llama", "ulysses", {}),
    ("tiny-llama", "ring", {"kv_cache_dtype": "int8"}),
    ("tiny-mistral", "ring", {}),
    ("tiny-mistral", "ulysses", {}),
], ids=["ring", "ulysses", "ring_int8_kv", "window_ring", "window_ulysses"])
def test_engine_generates_reference_tokens_on_sp_mesh(weights, name, mode,
                                                      serving):
    engine = _sp_engine(weights, name, mode=mode, **serving)
    got, reasons = engine.generate([PROMPT], max_new_tokens=8)
    want, want_reasons = _jref(weights, name, **serving).generate(
        [PROMPT], max_new_tokens=8)
    assert engine.sp_calls == tl.CONFIGS[name].num_layers
    assert (got, reasons) == (want, want_reasons)


def test_tensor_by_sequence_mesh(weights):
    """sp composes with tensor parallelism: each tensor shard's heads
    run on that shard's sequence ring."""
    name = "tiny-llama"
    mesh = tmesh.build_mesh(MeshConfig(sequence=2, tensor=2), [CPU] * 4)
    engine = GenerationEngine(
        tl.CONFIGS[name],
        ServingConfig(mesh=MeshConfig(sequence=2, tensor=2),
                      sp_prefill_min_seq=64),
        params=params_from_numpy(weights[name][1], CPU), mesh=mesh)
    assert engine.mesh_stats()["mesh_shape"] == "tensor=2,sequence=2"
    got, _ = engine.generate([PROMPT], max_new_tokens=8)
    want, _ = _jref(weights, name).generate([PROMPT], max_new_tokens=8)
    assert got == want


async def test_batcher_sp_admission(weights):
    """The batcher's fused admission (a fresh mini cache sized to the
    bucket) takes the sp path for a prompt at the threshold; a short
    prompt's does not; both stream the reference's greedy tokens."""
    engine = _sp_engine(weights, "tiny-llama")
    batcher = ContinuousBatcher(engine, BatchingConfig(max_batch_size=4))
    short = PROMPT[:9]
    want, _ = _jref(weights, "tiny-llama").generate([PROMPT, short],
                                                    max_new_tokens=6)
    batcher.start()
    try:
        async def one(prompt):
            ids = []
            async for chunk, _ in batcher.submit(prompt, 6, SamplingConfig(),
                                                 seed=0):
                ids.extend(chunk)
            return ids
        long_ids = await one(PROMPT)
        assert engine.sp_calls == tl.CONFIGS["tiny-llama"].num_layers
        short_ids = await one(short)
        assert engine.sp_calls == tl.CONFIGS["tiny-llama"].num_layers
    finally:
        await batcher.stop()
    assert [long_ids, short_ids] == want


def test_engine_refusals(weights):
    with pytest.raises(ValueError, match="sp_prefill does not compose "
                       "with kv_ring"):
        _sp_engine(weights, "tiny-mistral", kv_ring=True)
    with pytest.raises(ValueError, match=r"ulysses sp_prefill needs heads "
                       r"\(8\) divisible by the sequence axis \(16\)"):
        _sp_engine(weights, "tiny-llama", n=16, mode="ulysses")
    with pytest.raises(ValueError, match="unknown serving.sp_prefill"):
        ServingConfig(sp_prefill="zigzag")
    # Off or on a one-device mesh, the local path.
    assert not GenerationEngine(tl.CONFIGS["tiny-llama"],
                                ServingConfig(sp_prefill="ring"),
                                device="cpu").sp_prefill


async def test_sp_prefill_sidecar_generate(weights):
    """A sidecar on a sequence mesh answers Generate with the tokens of
    the reference engine (the sp admission behind gRPC)."""
    import grpc

    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    serving = ServingConfig(mesh=MeshConfig(sequence=2, tensor=1),
                            sp_prefill_min_seq=64,
                            batching=BatchingConfig(max_batch_size=4))
    side = Sidecar(serving, params=params_from_numpy(
        weights["tiny-llama"][1], CPU), device="cpu")
    port = await side.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            call = ch.unary_unary(
                "/ggrmcp.tpu.GenerateService/Generate",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateResponse.FromString)
            text = "a long enough prompt to reach the bucket of sixty-four!"
            resp = await asyncio.wait_for(call(serving_pb2.GenerateRequest(
                prompt=text, max_new_tokens=6, return_tokens=True)), 60)
    finally:
        await side.stop()
    ids = side.tokenizer.encode(text)
    want, _ = _jref(weights, "tiny-llama").generate([ids], max_new_tokens=6)
    assert list(resp.token_ids) == want[0]
