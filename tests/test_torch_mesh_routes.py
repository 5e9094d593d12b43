"""The routes the port now serves on a mesh, held to the JAX package on
the CPU (the port's mesh is the CPU repeated; the reference's outputs do
not depend on its mesh, so its one-device engine is the witness unless a
test names another), tiny models in float32 from one weight tree
crossed through numpy:
- the embedding engine at tensor=2 and data=2 x tensor=2 against the JAX
  engine on the same mesh (atol 1e-5, tests/test_torch_embed.py's), and
  the embed sidecar's mesh identity;
- LoRA at tensor=2 (`lora_qkv_b` split by wqkv's head-aligned columns,
  `a` replicated): boot-time adapters and the registry's arena (loads
  installing a row into every shard), each stream equal to its adapter
  served alone by the JAX engine, a zero-b adapter equal to base;
- page export and import across tensor=1 and tensor=2, both ways: the
  codec's [L, P, KVH, Dh] with every KV head once in head order (the
  JAX export's pages within 1e-5), bit-identical after a round trip, and
  the first tokens of the decode leg equal to the JAX mixed batcher's;
- the host page tier at tensor=2 (demotions and restores) with the JAX
  batcher's tokens and counters; roles on a mesh;
- the ring cache at tensor=2 and under stage=2 (the reference's staged
  ring), tiny-mistral, with the JAX ring batcher's tokens, the kernel
  taken by the fused admission's fresh prefill only, as at one device;
  the length tiers at tensor=2 with the JAX tiers' tokens.
"""

import asyncio
import os

import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import LoraConfig as JLora
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import bert as jb
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import EmbeddingEngine as JEmbedding
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.tiered import TieredBatcher as JTiered
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    LoraConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine, GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.serving.tiered import TieredBatcher
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
NAME = "tiny-llama"
CFG, JCFG = tl.CONFIGS[NAME], jl.CONFIGS[NAME]
RANK = 4


def _full(axes):
    return {"data": 1, "tensor": 1, **axes}


def _n(axes):
    return int(np.prod(list(axes.values())))


def _jmesh(axes):
    return jmesh.build_mesh(JMesh(**_full(axes)), jax.devices()[:_n(axes)])


def _tmesh(axes):
    return tmesh.build_mesh(MeshConfig(**_full(axes)), [CPU] * _n(axes))


def _copy(tree):
    return {**tree, "layers": dict(tree["layers"])}


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jref(weights):
    return JEngine(JCFG, JServing(), mesh=_jmesh({}),
                   params=_copy(weights[0]))


def _teng(weights, axes, cfg=CFG, host=None, **serving):
    return GenerationEngine(
        cfg, ServingConfig(mesh=MeshConfig(**_full(axes)), **serving),
        params=params_from_numpy(_copy(host or weights[1]), CPU),
        mesh=_tmesh(axes))


async def _collect(batcher, prompt, max_new, reference=False, **kw):
    out, reason = [], None
    greedy = JSampling() if reference else SamplingConfig()
    async for ids, reason in batcher.submit(prompt, max_new, greedy, **kw):
        out.extend(ids)
    assert reason in ("stop", "length")
    return out


def prompt_of(n: int, salt: int = 0) -> list[int]:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


# -- the embedding engine -------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(data=2, tensor=2)],
                         ids=["tensor2", "data2_tensor2"])
def test_embed_on_the_mesh_matches_reference(axes):
    cfg = jb.CONFIGS["bert-tiny"]
    jparams = jb.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.asarray, jparams)
    jeng = JEmbedding(cfg, JServing(mesh=JMesh(**_full(axes))),
                      mesh=_jmesh(axes), params=jparams)
    teng = EmbeddingEngine(tb.CONFIGS["bert-tiny"],
                           params=params_from_numpy(host, CPU),
                           mesh=_tmesh(axes))
    assert isinstance(teng.params["layers"]["wqkv"], Sharded)
    rng = np.random.default_rng(0)
    lists = [rng.integers(1, 30522, n).tolist() for n in (5, 40, 17, 100)]
    for pooling in ("mean", "cls"):
        np.testing.assert_allclose(teng.embed(lists, pooling),
                                   jeng.embed(lists, pooling), atol=1e-5,
                                   rtol=0)
    info = teng.model_info()
    assert info["mesh"] == jeng.model_info()["mesh"] == {
        a: n for a, n in _full(axes).items() if n > 1}


def test_embed_sidecar_on_a_mesh():
    side = Sidecar(ServingConfig(model="bert-tiny",
                                 mesh=MeshConfig(tensor=2)), device="cpu")
    assert side.embedding is not None and side.generation is None
    assert side.embedding.mesh.shape["tensor"] == 2
    assert side.embedding.model_info()["num_devices"] == 2
    vec = side.embedding.embed([[101, 7, 8, 102]])
    assert vec.shape == (1, 128) and np.isclose(np.linalg.norm(vec), 1.0)


# -- LoRA -----------------------------------------------------------------------


def factors(seed: int, scale: float = 0.25):
    rng = np.random.default_rng(seed)
    out = (JCFG.num_heads + 2 * JCFG.num_kv_heads) * JCFG.head_dim
    a = rng.normal(0, scale, (JCFG.num_layers, JCFG.hidden_dim, RANK))
    b = rng.normal(0, scale, (JCFG.num_layers, RANK, out))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lora-registry"))
    for i, name in enumerate(("a0", "a1", "a2")):
        a, b = factors(10 + i)
        np.savez(os.path.join(path, f"{name}.npz"), a=a, b=b)
    return path


P = prompt_of(12, salt=3)


@pytest.mark.parametrize("mode", ["static", "arena"])
async def test_lora_on_the_mesh_matches_reference(weights, registry, mode):
    lora = (dict(adapters=["a0", "zero"], rank=RANK) if mode == "static"
            else dict(registry=registry, rank=RANK, arena_rows=2))
    jeng = JEngine(JCFG, JServing(lora=JLora(**lora)), mesh=_jmesh({}),
                   params=_copy(weights[0]))
    teng = _teng(weights, dict(tensor=2), lora=LoraConfig(**lora))
    b_leaf = teng.params["layers"]["lora_qkv_b"]
    assert isinstance(b_leaf, Sharded) and b_leaf.factors[-1] == 2
    a_leaf = teng.params["layers"]["lora_qkv_a"]
    assert len(a_leaf.distinct()) == 1
    if mode == "static":
        for eng in (jeng, teng):
            eng.set_lora_weights("a0", *factors(10))
        names = ["a0", "", "zero", "a0"]
    else:
        names = ["a0", "", "a1", "a2"]  # three adapters over two rows
    batcher = ContinuousBatcher(teng, BatchingConfig(max_batch_size=4,
                                                     kv_cache_max_seq=128))
    batcher.start()
    try:
        got = []
        for wave in (names[:2], names[2:]):
            got += await asyncio.gather(*(
                _named(batcher, teng, P + [i], n) for i, n in enumerate(wave)))
    finally:
        await batcher.stop()
    for i, (name, out) in enumerate(zip(names, got)):
        want, _ = jeng.generate([P + [i % 2]], max_new_tokens=5,
                                adapters=[name])
        assert out == want[0], name
    base, _ = jeng.generate([P + [0]], max_new_tokens=5)
    if mode == "static":
        assert got[2] == base[0] != got[0]  # a zero-b adapter is base
    else:
        assert teng.lora_stats()["lora_evictions"] >= 1


async def _named(batcher, engine, prompt, name):
    if not name:
        return await _collect(batcher, prompt, 5)
    if engine.adapter_arena is None:
        return await _collect(batcher, prompt, 5,
                              adapter=engine.resolve_adapter(name))
    lease = await batcher.acquire_adapter(name)
    return await _collect(batcher, prompt, 5, adapter=lease.row,
                          adapter_key=name, adapter_lease=lease)


# -- pages across meshes, the host tier, roles ------------------------------------


def _paged(**kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("paged_kv", "on")
    kw.setdefault("paged_kv_page_size", 8)
    return kw


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2)],
                         ids=["tensor2_to_1", "tensor1_to_2"])
async def test_pages_ship_across_meshes(weights, jref, src, dst):
    prompt = prompt_of(50, salt=src)
    a = ContinuousBatcher(_teng(weights, dict(tensor=src)),
                          BatchingConfig(**_paged()))
    b = ContinuousBatcher(_teng(weights, dict(tensor=dst)),
                          BatchingConfig(**_paged()))
    j = JBatcher(jref, JBatching(**_paged()))
    for x in (a, b, j):
        x.start()
    try:
        await _collect(a, prompt, 1)
        await _collect(j, prompt, 1, reference=True)
        export = await a.run_host_op(lambda: a.export_prompt_kv(prompt))
        jexport = await j.run_host_op(lambda: j.export_prompt_kv(prompt))
        assert export["k"].shape == (CFG.num_layers, 6, 8, CFG.num_kv_heads,
                                     CFG.head_dim)
        for name in ("k", "v"):
            np.testing.assert_allclose(export[name].numpy(),
                                       np.asarray(jexport[name]), atol=1e-5,
                                       rtol=0)
        imported, present = await b.run_host_op(lambda: b.import_prompt_kv(
            prompt, 0, export["k"], export["v"]))
        assert (imported, present) == (export["pages"], 0)
        again = b._gather_pages(b.pages.chain_pages(prompt))
        for name in ("k", "v"):
            assert torch.equal(again[name], export[name])
        out = await _collect(b, prompt, 8)
        want = await _collect(j, prompt, 8, reference=True)
    finally:
        for x in (a, b, j):
            await x.stop()
    assert out == want
    assert b.pages.hits == 1


async def test_host_tier_on_the_mesh_matches_reference(weights, jref):
    cfg = _paged(max_batch_size=2, kv_cache_max_seq=128, paged_kv_pages=16,
                 paged_kv_host_bytes=64 << 20, prefill_chunk=32)
    prompts = ([prompt_of(32, salt=s) + [400 + s] for s in range(4)] * 2
               + [prompt_of(80, salt=9)])

    async def run(batcher, reference=False):
        batcher.start()
        try:
            outs = [await _collect(batcher, p, 4, reference=reference,
                                   seed=i)
                    for i, p in enumerate(prompts)]
            stats = (batcher.counter_stats() if reference
                     else batcher.stats())
        finally:
            await batcher.stop()
        return outs, stats

    want, jstats = await run(JBatcher(jref, JBatching(**cfg)), True)
    tb_ = ContinuousBatcher(_teng(weights, dict(tensor=2)),
                            BatchingConfig(**cfg))
    got, stats = await run(tb_)
    assert got == want
    keys = ("kv_host_demotions", "kv_host_restores", "paged_prefix_hits")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["kv_host_demotions"] > 0 and stats["kv_host_restores"] > 0
    tb_.pages.check_invariants()


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_roles_on_a_mesh(weights, role):
    side = Sidecar(ServingConfig(
        model=NAME, role=role, mesh=MeshConfig(tensor=2),
        batching=BatchingConfig(**_paged())),
        params=params_from_numpy(_copy(weights[1]), CPU), device="cpu")
    assert side.batcher.stats()["mesh_shape"] == "tensor=2"
    assert isinstance(side.batcher.cache.k, Sharded)


# -- the ring and the tiers ---------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(stage=2)],
                         ids=["tensor2", "stage2"])
async def test_ring_on_the_mesh_matches_reference(monkeypatch, axes):
    """tiny-mistral (window 16) with the ring cache: a short and a long
    prompt decoding past the window, the JAX ring batcher's tokens; the
    ring's attention reads by absolute position (the plain path), so
    only a fresh prefill into a contiguous mini cache takes the
    kernel."""
    name = "tiny-mistral"
    jcfg, cfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    bkw = dict(max_batch_size=2, kv_cache_max_seq=256, prefill_chunk=16)
    jeng = JEngine(jcfg, JServing(model=name, kv_ring=True,
                                  batching=JBatching(**bkw)),
                   mesh=_jmesh({}), params=jparams)
    teng = _teng(None, axes, cfg, host, model=name, kv_ring=True,
                 batching=BatchingConfig(**bkw))
    assert teng.ring_capacity == jeng.ring_capacity
    calls = []
    real = tatt.flash_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    spy.launches = 0  # the batcher's admission spans read the counter
    monkeypatch.setattr(tatt, "flash_attention", spy)
    prompts = [prompt_of(6, salt=1), prompt_of(40, salt=2)]

    async def run(batcher, reference=False):
        batcher.start()
        try:
            return await asyncio.gather(*(
                _collect(batcher, p, 30, reference=reference)
                for p in prompts))
        finally:
            await batcher.stop()

    want = await run(JBatcher(jeng, JBatching(**bkw)), True)
    got = await run(ContinuousBatcher(teng, BatchingConfig(**bkw)))
    assert got == want
    # Only the fused admission's fresh prefill (a contiguous mini cache)
    # takes the kernel, once a layer and shard, as at one device; a
    # stage's attention is pinned to the plain path.
    on_mesh = len(calls)
    calls.clear()
    one = _teng(None, {}, cfg, host, model=name, kv_ring=True,
                batching=BatchingConfig(**bkw))
    assert await run(ContinuousBatcher(one, BatchingConfig(**bkw))) == want
    assert len(calls) > 0
    assert on_mesh == (0 if "stage" in axes
                       else len(calls) * axes.get("tensor", 1))


MIX = [(5, 6, 0.0, 1), (8, 4, 0.8, 2), (12, 6, 0.0, 3), (100, 6, 0.0, 4),
       (90, 4, 0.8, 6)]


async def test_tiers_on_the_mesh_match_reference(weights, jref):
    cfg = dict(kv_tiers=[[64, 3], [256, 1]], max_queue_delay_ms=1000.0)

    async def mix(tiered, sampling_cls):
        its = [tiered.submit([3 + (seed * 7 + i) % 40 for i in range(n)], m,
                             sampling_cls(temperature=temp,
                                          top_k=20 if temp else 0),
                             seed=seed)
               for n, m, temp, seed in MIX]
        tiered.start()

        async def one(it):
            ids = []
            async for chunk, _ in it:
                ids.extend(chunk)
            return ids

        try:
            return await asyncio.gather(*(one(it) for it in its))
        finally:
            await tiered.stop()

    engine = _teng(weights, dict(tensor=2))
    tiered = TieredBatcher(engine, BatchingConfig(**cfg))
    got = await mix(tiered, SamplingConfig)
    want = await mix(JTiered(jref, JBatching(**cfg)), JSampling)
    assert got == want
    assert all(isinstance(t.cache.k, Sharded) for t in tiered.tiers)
    stats = tiered.stats()
    assert stats["mesh_shape"] == "tensor=2"
    assert stats["kv_cache_bytes"] == tiered.cache_bytes()
    # The tiers' ledger scopes partition the pools on the mesh.
    comps = engine.ledger.reconcile()["components"]
    arenas = {k: v for k, v in comps.items() if k.endswith("/kv_arena")}
    assert set(arenas) == {"tier-64/kv_arena", "tier-256/kv_arena"}
    assert all(v > 0 for v in arenas.values())
