"""Pipeline-parallel serving in the port (the counterpart of
`tests/test_pp_serving.py`): `parallel/pipeline.py`'s staged cached
forward against the JAX package's `pipeline_forward_cached` on a stage=2
x tensor=2 mesh (`jax.devices()[:4]` of the suite's forced 8-device CPU
platform; the port's mesh is the CPU repeated 4 times), prefill and a
decode step, logits within 1e-4 and the cache within 1e-5 (float32
tiny-llama, the same weights crossed through numpy); the engine's greedy
tokens and the batcher's (fused and chunked admissions) on stage meshes
equal to the JAX single-device engine's, with int8 weights and with the
int8 KV cache; and the reference's refusals under PP (speculative
decoding, indivisible layers, MoE, paged KV, LoRA); the ring cache
under stage is served (its parity: tests/test_torch_mesh_routes.py)."""

import asyncio
import functools

import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.parallel import pipeline as jpipe
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    LoraConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel import pipeline as tpipe
from ggrmcp_tpu_torch.parallel.collectives import unshard
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
NAME = "tiny-llama"
CFG, JCFG = tl.CONFIGS[NAME], jl.CONFIGS[NAME]
LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5],
           [3 + (i * 7 % 490) for i in range(40)]]  # > prefill_chunk 16


def _tmesh(stage, tensor=1):
    return tmesh.build_mesh(MeshConfig(stage=stage, tensor=tensor),
                            [CPU] * (stage * tensor))


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(5), JCFG)


@pytest.fixture(scope="module")
def host(jparams):
    return jax.tree.map(np.asarray, jparams)


def _engine(host, stage, tensor=1, **serving):
    engine = GenerationEngine(
        CFG, ServingConfig(mesh=MeshConfig(stage=stage, tensor=tensor),
                           **serving),
        params=params_from_numpy(host, CPU), mesh=_tmesh(stage, tensor))
    assert engine.pp_serving == (stage > 1)
    return engine


@pytest.fixture(scope="module")
def jref(jparams):
    return JEngine(JCFG, JServing(),
                   mesh=jmesh.build_mesh(JMesh(tensor=1), jax.devices()[:1]),
                   params=jparams)


@pytest.fixture(scope="module")
def want(jref):
    return jref.generate(PROMPTS, max_new_tokens=8, seed=0)


def test_staged_prefill_and_decode_match_reference(jparams, host):
    jm = jmesh.build_mesh(JMesh(stage=2, tensor=2, data=1),
                          jax.devices()[:4])
    jfwd = jax.jit(functools.partial(jpipe.pipeline_forward_cached, cfg=JCFG,
                                     mesh=jm))
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size,
                                               (4, 16)).astype(np.int32)
    jcache = jl.KVCache.create(JCFG, 4, 32)
    j_pre, jcache = jfwd(jparams, tokens=tokens, cache=jcache)
    nxt = np.array([[7], [9], [11], [13]], np.int32)
    j_dec, jcache = jfwd(jparams, tokens=nxt, cache=jcache)

    engine = _engine(host, 2, 2)
    cache = engine.make_cache(4, 32)
    pre, cache = tpipe.pipeline_forward_cached(
        engine.params, CFG, torch.from_numpy(tokens), cache, engine.mesh)
    dec, cache = tpipe.pipeline_forward_cached(
        engine.params, CFG, torch.from_numpy(nxt), cache, engine.mesh)
    for got, ref in ((pre, j_pre), (dec, j_dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()
    # The staged cache, put back whole: [L, B, S, KVH, D] (the port's
    # scratch slot dropped), against the reference's.
    k = unshard(cache.k, tpipe.cache_specs_pp()["k"])[:, :, :32]
    np.testing.assert_allclose(k.numpy(), np.asarray(jcache.k),
                               atol=CACHE_ATOL, rtol=CACHE_ATOL)
    assert cache.k.parts[0].shape[0] == CFG.num_layers // 2


@pytest.mark.parametrize("stage,tensor", [(2, 1), (4, 1), (2, 2)])
def test_greedy_generation_matches_single_device(host, want, stage, tensor):
    engine = _engine(host, stage, tensor)
    assert engine.mesh_stats()["mesh_shape"] == ",".join(
        f"{a}={n}" for a, n in (("tensor", tensor), ("stage", stage))
        if n > 1)
    assert engine.generate(PROMPTS, max_new_tokens=8, seed=0) == want


async def _burst(engine, prompts, max_new=8):
    batcher = ContinuousBatcher(engine, BatchingConfig(
        max_batch_size=4, prefill_chunk=16, max_queue_delay_ms=1000.0))
    batcher.start()

    async def one(prompt):
        ids = []
        async for chunk, _ in batcher.submit(prompt, max_new,
                                             SamplingConfig(), seed=0):
            ids.extend(chunk)
        return ids
    try:
        out = await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await batcher.stop()
    return out, batcher


async def test_batcher_on_pp_mesh(host, want):
    out, batcher = await _burst(_engine(host, 2, 2), PROMPTS)
    assert batcher.fused_admissions > 0 and batcher.chunked_admissions > 0
    assert out == want[0]


@pytest.mark.parametrize("serving", [{"quantize": "int8"},
                                     {"kv_cache_dtype": "int8"}],
                         ids=["int8_weights", "int8_kv"])
async def test_int8_on_pp_mesh_matches_single_device(host, jparams, serving):
    ref = JEngine(JCFG, JServing(**serving),
                  mesh=jmesh.build_mesh(JMesh(tensor=1), jax.devices()[:1]),
                  params=jparams)
    want, _ = ref.generate(PROMPTS, max_new_tokens=8, seed=0)
    engine = _engine(host, 2, 1, **serving)
    assert engine.generate(PROMPTS, max_new_tokens=8, seed=0)[0] == want
    out, _ = await _burst(_engine(host, 2, 1, **serving), PROMPTS)
    assert out == want


@pytest.mark.parametrize("model,serving,match", [
    (NAME, dict(speculative_draft=NAME), "speculative decoding is not "
     "supported under pipeline-parallel serving"),
    ("tiny-moe", {}, "pipeline-parallel serving supports dense Llama only"),
    (NAME, dict(lora=LoraConfig(adapters=["a"])), "lora does not compose "
     "with pipeline-parallel serving"),
    ("tiny-mistral", dict(kv_ring=True), None),
], ids=["speculative", "moe", "lora", "ring"])
def test_refusals_under_pp(model, serving, match):
    """The reference's refusals under PP; the ring cache (`match` None)
    is served, as the reference's staged ring is."""
    from ggrmcp_tpu_torch.models import get_model

    def build():
        return GenerationEngine(
            get_model(model)[1],
            ServingConfig(mesh=MeshConfig(stage=2, tensor=1), **serving),
            mesh=_tmesh(2))

    if match is None:
        engine = build()
        assert engine.pp_serving and engine.ring_capacity
        return
    with pytest.raises(ValueError, match=match):
        build()


def test_indivisible_layers_and_paged_refused(host):
    with pytest.raises(ValueError, match="4 layers not divisible by stage=8"):
        GenerationEngine(CFG, ServingConfig(mesh=MeshConfig(stage=8)),
                         mesh=_tmesh(8))
    with pytest.raises(ValueError, match="paged_kv does not compose with "
                       "pipeline-parallel serving"):
        ContinuousBatcher(_engine(host, 2), BatchingConfig(paged_kv="on"))


def test_sp_disabled_under_pp(caplog):
    mesh = tmesh.build_mesh(MeshConfig(stage=2, sequence=2, tensor=1),
                            [CPU] * 4)
    engine = GenerationEngine(
        CFG, ServingConfig(mesh=MeshConfig(stage=2, sequence=2, tensor=1)),
        mesh=mesh)
    assert engine.pp_serving and not engine.sp_prefill
    assert "sp_prefill disabled under pipeline serving" in caplog.text


async def test_prefix_pool_on_pp_mesh_matches_one_device(host):
    """The prefix pool's routes (a stored prompt, then a hit that extends
    it) on a stage=2 mesh: the pool's entries are staged caches too, and
    the tokens equal one device's."""
    pre = [3 + (i * 11 % 490) for i in range(40)]
    prompts = [pre + [7, 8], pre + [9]]
    pool = dict(prefix_cache_entries=4, prefix_cache_min_seq=16,
                prefix_cache_max_seq=128)

    async def run(stage):
        batcher = ContinuousBatcher(_engine(host, stage), BatchingConfig(
            max_batch_size=4, prefill_chunk=16, **pool))
        batcher.start()
        out = []
        try:
            for prompt in prompts:
                ids = []
                async for chunk, _ in batcher.submit(prompt, 8,
                                                     SamplingConfig(),
                                                     seed=0):
                    ids.extend(chunk)
                out.append(ids)
        finally:
            await batcher.stop()
        return out, batcher.prefix_hits

    got, hits = await run(2)
    assert hits == 1
    assert got == (await run(1))[0]
