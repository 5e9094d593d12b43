"""The sequence and pipeline meshes composed, held to the JAX package: the
compositions the port serves that no other CPU test file takes.

- Sequence-parallel prefill (ring and Ulysses at sequence=2) on int8
  weights, and Ulysses on the int8 KV cache: a fresh prefill's logits
  against the JAX engine's on the same mesh (`jax.devices()[:2]` of the
  suite's forced 8-device CPU platform; the port's mesh is the CPU
  repeated) within 1e-4, the engine's greedy tokens against the JAX
  engine's (exact), the sp attention called once a layer.
- Int8 weights on stage and tensor meshes: each quantized leaf, put
  back whole, is the reference's quantization of the whole leaf bit for
  bit (the per-channel max of a row-parallel leaf once spanned every
  stage's layers at stage x tensor).
- stage=2 x tensor=2 on int8 weights and on the int8 cache (the
  reference's own pin, `tests/test_pp_serving.py`): the staged forward's
  prefill and decode logits against the JAX package's
  `pipeline_forward_cached` on the same quantized tree within 1e-4, then
  the engine's and the batcher's greedy tokens against the JAX engine's.
- The prefix pool at stage=2 x tensor=2, on the model's cache and on the
  int8 cache: a stored prompt, then a hit, the tokens the JAX engine's.
- sequence=2 x tensor=2: a batcher and a sidecar take the sp admission
  for a long prompt (the sp attention once a tensor shard a layer) and
  the local one for a short prompt, both with the JAX engine's tokens.

tiny-llama, float32, weights drawn by the JAX package and crossed through
`params_from_numpy`; each JAX reference run is made once in a
module-scoped fixture.
"""

import asyncio
import functools

import grpc
import grpc.aio
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops import quant as jquant
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.parallel import pipeline as jpipe
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig, MeshConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel import pipeline as tpipe
from ggrmcp_tpu_torch.parallel.collectives import unshard
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving import tensors
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
NAME = "tiny-llama"
CFG, JCFG = tl.CONFIGS[NAME], jl.CONFIGS[NAME]
# Logits against the JAX package's: the quantized weights are the same
# bits on both sides (the reference's `quantize_model` run eagerly, as
# the port's is), so float32 summation order alone; on the int8 cache the
# JAX forward quantizes K/V under jit, whose float32 scales may sit one
# ulp off the port's and flip an int8 rounding (test_torch_quant.py's
# ATOL_KV).
LOGITS_ATOL = {"int8_weights": 1e-4, "int8_kv": 1e-2, "int8_both": 1e-2}
NEW = 8
SP_MIN_SEQ = 64
# A prompt that buckets to 64 (sp at sp_prefill_min_seq 64), a short one
# that buckets to 32 (the local path), and one longer than the batcher's
# prefill_chunk of 16 (a chunked admission).
LONG = [3 + (i * 7 % 490) for i in range(37)]
SHORT = [9, 2, 6, 5, 3, 5]
PROMPTS = [LONG, SHORT]
# The reference's serving settings of each composition.
SERVINGS = {
    "int8_weights": dict(quantize="int8"),
    "int8_kv": dict(kv_cache_dtype="int8"),
    "int8_both": dict(quantize="int8", kv_cache_dtype="int8"),
    "plain": {},
}


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(11), JCFG)


@pytest.fixture(scope="module")
def host(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def want(jparams):
    """The JAX engine on one device, each serving setting: greedy tokens
    and finish reasons of PROMPTS (and of each prompt alone), made once."""
    cache: dict = {}

    def get(key: str):
        if key not in cache:
            ref = JEngine(JCFG, JServing(sp_prefill="", **SERVINGS[key]),
                          mesh=jmesh.build_mesh(JMesh(tensor=1),
                                                jax.devices()[:1]),
                          params=jparams)
            cache[key] = ref.generate(PROMPTS, max_new_tokens=NEW, seed=0)
        return cache[key]
    return get


def _jtree(jparams, serving: dict):
    """The JAX tree `serving` serves: int8 weights quantized eagerly."""
    return (jquant.quantize_model(jparams) if serving.get("quantize")
            else jparams)


def _engine(host, serving: dict, **axes) -> GenerationEngine:
    mcfg = MeshConfig(tensor=axes.pop("tensor", 1), **axes)
    n = mcfg.tensor * mcfg.sequence * mcfg.stage
    return GenerationEngine(
        CFG, ServingConfig(mesh=mcfg, sp_prefill_min_seq=SP_MIN_SEQ,
                           **serving),
        params=params_from_numpy(host, CPU),
        mesh=tmesh.build_mesh(mcfg, [CPU] * n))


async def _serve(batcher, prompts, concurrent=True, max_new=NEW):
    async def one(prompt):
        ids = []
        async for chunk, _ in batcher.submit(prompt, max_new,
                                             SamplingConfig(), seed=0):
            ids.extend(chunk)
        return ids
    batcher.start()
    try:
        if concurrent:
            return list(await asyncio.gather(*(one(p) for p in prompts)))
        return [await one(p) for p in prompts]
    finally:
        await batcher.stop()


# -- sequence parallelism on int8 -----------------------------------------


@pytest.mark.parametrize("mode,key", [
    ("ring", "int8_weights"), ("ulysses", "int8_weights"),
    ("ulysses", "int8_kv"), ("ring", "int8_both"),
], ids=["ring-int8_weights", "ulysses-int8_weights", "ulysses-int8_kv",
        "ring-int8_both"])
def test_sp_prefill_on_int8_matches_reference(jparams, host, want, mode,
                                              key):
    serving = dict(sp_prefill=mode, **SERVINGS[key])
    engine = _engine(host, serving, sequence=2)
    assert engine.sp_prefill == mode
    tokens = np.random.default_rng(2).integers(
        3, CFG.vocab_size, (2, SP_MIN_SEQ)).astype(np.int32)
    jeng = JEngine(JCFG, JServing(
        mesh=JMesh(tensor=1, sequence=2), sp_prefill=mode,
        sp_prefill_min_seq=SP_MIN_SEQ,
        kv_cache_dtype=serving.get("kv_cache_dtype", "")),
        mesh=jmesh.build_mesh(JMesh(tensor=1, sequence=2, data=1),
                              jax.devices()[:2]),
        params=jparams)
    j_logits, _ = jax.jit(jeng.prefill_forward)(
        _jtree(jparams, serving), tokens,
        jl.KVCache.create(JCFG, 2, SP_MIN_SEQ, jeng.kv_dtype))
    with torch.no_grad():
        logits, _ = engine.prefill_forward(
            engine.params, torch.from_numpy(tokens).long(),
            engine.make_cache(2, SP_MIN_SEQ))
    assert engine.sp_calls == CFG.num_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=LOGITS_ATOL[key], rtol=LOGITS_ATOL[key])
    engine.sp_calls = 0
    assert engine.generate(PROMPTS, max_new_tokens=NEW, seed=0) == want(key)
    # The batch buckets to 64: one sp prefill, then decode steps.
    assert engine.sp_calls == CFG.num_layers


# -- stage x tensor on int8 -----------------------------------------------


@pytest.mark.parametrize("stage,tensor", [(2, 2), (4, 2), (2, 1), (1, 2)])
def test_int8_leaves_on_stage_by_tensor_are_the_whole_quantization(
        jparams, host, stage, tensor):
    """Every quantized leaf, put back whole from its shards, is the JAX
    package's eager `quantize_model` of the whole tree bit for bit: a
    row-parallel leaf's per-channel max spans the tensor shards of its
    own stage's layers, never another stage's."""
    engine = _engine(host, SERVINGS["int8_weights"], stage=stage,
                     tensor=tensor)
    jtree = jquant.quantize_model(jparams)
    for name in ("wqkv", "wo", "w_gate", "w_up", "w_down"):
        leaf = engine.params["layers"][name]
        index_fn = tl.shard_index_fn(CFG, name)
        for part, ref in ((leaf.q, jtree["layers"][name].q),
                          (leaf.scale, jtree["layers"][name].scale)):
            got = unshard(part, part.spec, index_fn)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          err_msg=name)


@pytest.mark.parametrize("key", ["int8_weights", "int8_kv"])
def test_staged_forward_by_tensor_on_int8_matches_reference(jparams, host,
                                                            key):
    serving = SERVINGS[key]
    jm = jmesh.build_mesh(JMesh(stage=2, tensor=2, data=1),
                          jax.devices()[:4])
    jtree = _jtree(jparams, serving)
    jfwd = jax.jit(functools.partial(jpipe.pipeline_forward_cached, cfg=JCFG,
                                     mesh=jm))
    tokens = np.random.default_rng(3).integers(
        3, CFG.vocab_size, (4, 16)).astype(np.int32)
    nxt = np.array([[7], [9], [11], [13]], np.int32)
    jcache = jl.KVCache.create(JCFG, 4, 32,
                               serving.get("kv_cache_dtype", ""))
    j_pre, jcache = jfwd(jtree, tokens=tokens, cache=jcache)
    j_dec, jcache = jfwd(jtree, tokens=nxt, cache=jcache)

    engine = _engine(host, serving, stage=2, tensor=2)
    assert engine.pp_serving
    cache = engine.make_cache(4, 32)
    with torch.no_grad():
        pre, cache = tpipe.pipeline_forward_cached(
            engine.params, CFG, torch.from_numpy(tokens).long(), cache,
            engine.mesh)
        dec, cache = tpipe.pipeline_forward_cached(
            engine.params, CFG, torch.from_numpy(nxt).long(), cache,
            engine.mesh)
    for got, ref in ((pre, j_pre), (dec, j_dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGITS_ATOL[key],
                                   rtol=LOGITS_ATOL[key])
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()


@pytest.mark.parametrize("key", ["int8_weights", "int8_kv"])
async def test_stage_by_tensor_on_int8_serves_reference_tokens(host, want,
                                                               key):
    engine = _engine(host, SERVINGS[key], stage=2, tensor=2)
    assert engine.mesh_stats()["mesh_shape"] == "tensor=2,stage=2"
    assert engine.generate(PROMPTS, max_new_tokens=NEW, seed=0) == want(key)
    batcher = ContinuousBatcher(engine, BatchingConfig(
        max_batch_size=4, prefill_chunk=16, max_queue_delay_ms=1000.0))
    out = await _serve(batcher, PROMPTS)
    assert batcher.fused_admissions > 0 and batcher.chunked_admissions > 0
    assert out == want(key)[0]


# -- the prefix pool under PP ---------------------------------------------


@pytest.mark.parametrize("key", ["plain", "int8_kv"])
async def test_prefix_pool_on_stage_by_tensor_matches_reference(
        jparams, host, key):
    """A stored prompt, then a hit that extends it, on a stage=2 x
    tensor=2 mesh: the pool's staged entries (int8 leaves and their
    scales too) give the JAX engine's tokens for each prompt."""
    pre = [3 + (i * 13 % 490) for i in range(40)]
    prompts = [pre + [7, 8], pre + [9]]
    ref = JEngine(JCFG, JServing(**SERVINGS[key]),
                  mesh=jmesh.build_mesh(JMesh(tensor=1), jax.devices()[:1]),
                  params=jparams)
    expect = [ref.generate([p], max_new_tokens=NEW, seed=0)[0][0]
              for p in prompts]
    batcher = ContinuousBatcher(
        _engine(host, SERVINGS[key], stage=2, tensor=2),
        BatchingConfig(max_batch_size=4, prefill_chunk=16,
                       prefix_cache_entries=4, prefix_cache_min_seq=16,
                       prefix_cache_max_seq=128))
    got = await _serve(batcher, prompts, concurrent=False)
    assert batcher.prefix_hits == 1
    assert got == expect


# -- tensor x sequence: the admissions ------------------------------------


async def test_batcher_on_sequence_by_tensor_routes_admissions(host, want):
    engine = _engine(host, dict(sp_prefill="ulysses"), sequence=2, tensor=2)
    assert engine.mesh_stats()["mesh_shape"] == "tensor=2,sequence=2"
    batcher = ContinuousBatcher(engine, BatchingConfig(max_batch_size=4))
    batcher.start()
    try:
        async def one(prompt):
            ids = []
            async for chunk, _ in batcher.submit(prompt, NEW,
                                                 SamplingConfig(), seed=0):
                ids.extend(chunk)
            return ids
        long_ids = await one(LONG)
        # Once a tensor shard a layer.
        assert engine.sp_calls == 2 * CFG.num_layers
        short_ids = await one(SHORT)
        assert engine.sp_calls == 2 * CFG.num_layers
    finally:
        await batcher.stop()
    assert [long_ids, short_ids] == want("plain")[0]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
async def test_sidecar_on_sequence_by_tensor_serves_reference_tokens(
        host, want, mode):
    """A sidecar at sequence=2 x tensor=2 answers Generate for a long and a
    short prompt (`prompt_ids`, so the reference's prompts): the long one
    through the sp admission, the short one through the local one."""
    serving = ServingConfig(
        mesh=MeshConfig(tensor=2, sequence=2), sp_prefill=mode,
        sp_prefill_min_seq=SP_MIN_SEQ,
        batching=BatchingConfig(max_batch_size=4))
    side = Sidecar(serving, params=params_from_numpy(host, CPU),
                   mesh=tmesh.build_mesh(serving.mesh, [CPU] * 4))
    engine = side.generation
    assert engine.sp_prefill == mode
    port = await side.start(0)
    got, calls = [], []
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            call = ch.unary_unary(
                "/ggrmcp.tpu.GenerateService/Generate",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateResponse.FromString)
            for prompt in PROMPTS:
                before = engine.sp_calls
                resp = await asyncio.wait_for(call(
                    serving_pb2.GenerateRequest(
                        prompt_ids=tensors.to_proto(np.array(prompt,
                                                             np.int32)),
                        max_new_tokens=NEW, return_tokens=True)), 60)
                got.append(list(resp.token_ids))
                calls.append(engine.sp_calls - before)
    finally:
        await side.stop()
    assert calls == [2 * CFG.num_layers, 0]
    assert got == want("plain")[0]
