"""Tensor-parallel serving in the port (the counterpart of
`tests/test_tp.py`): tiny-llama in float32, the port's shards on the CPU
against the JAX package's engine and batchers on a 2-device mesh
(`jax.devices()[:2]` of the suite's forced 8-device CPU platform), both
from ONE host weight tree crossed through numpy. Cross-mesh identity is
meaningful only over identical weights: random init does not reproduce
across meshes, in either package.

What is held:
- logits of the port at tensor=2 within 1e-4 of the JAX 2-device
  engine's and of the port at tensor=1 (float32 sums in another order:
  every row-parallel product is a sum of two partials);
- greedy tokens identical to the JAX 2-device batcher through the fused
  wave, chunked and interleaved admission, the paged arena (pages
  shared), speculative ticks with a sharded draft and `tick_fail`
  replay; int8 weights, the int8 cache and grammar ticks against the
  port at tensor=1; sampled rows identical across meshes;
- the mesh identity (`mesh_stats`, GetServingStats, GetModelInfo) in the
  reference's values and formats, at one device too, and the downgrade
  gauge: 0 at tensor=2, the reference's count at tensor=8, where the
  KV heads are replicated;
- the routes once refused on a mesh (LoRA, the ring, tiers, the host
  tier, roles, embeddings) start at tensor=2, and a page exported from a
  tensor=2 arena imports into a tensor=1 one.
"""

import asyncio
import dataclasses

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    GrammarConfig,
    LoraConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, KVTransferError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import failpoints as tfail
from tests import torch_threads  # noqa: F401

ATOL = 1e-4
CPU = torch.device("cpu")
NAME = "tiny-llama"
CFG = tl.CONFIGS[NAME]
JCFG = jl.CONFIGS[NAME]
MESH_KEYS = ("tp_chips", "mesh_devices", "mesh_shape",
             "mesh_spec_downgrades")

# No eos id (2) anywhere: parity compares full-length streams.
SHORT_A = [5, 6, 7, 9, 11]
SHORT_B = [13, 3, 44, 210, 87, 6]
PRE = [3 + (i * 11 % 490) for i in range(24)]
SHARED_A = PRE + [7, 8, 9]
SHARED_B = PRE + [30, 31]
LONG = [3 + (i * 7 % 500) for i in range(80)]  # > prefill_chunk: chunked
WAVE = [SHORT_A, SHORT_B, SHARED_A, SHARED_B, LONG]


def _jmesh(n):
    return jmesh.build_mesh(JMesh(tensor=n, data=1), jax.devices()[:n])


def _cross(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _serving(tensor, **kw):
    return ServingConfig(mesh=MeshConfig(tensor=tensor), **kw)


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(7), JCFG)


@pytest.fixture(scope="module")
def jeng2(jparams):
    return JEngine(JCFG, JServing(), mesh=_jmesh(2), params=jparams)


@pytest.fixture(scope="module")
def teng1(jparams):
    return GenerationEngine(CFG, _serving(1), params=_cross(jparams),
                            device="cpu")


@pytest.fixture(scope="module")
def teng2(jparams):
    return GenerationEngine(CFG, _serving(2), params=_cross(jparams),
                            device="cpu")


def _bcfg(cls, **kw):
    # A round's requests are all popped within the admission delay: at
    # the default 5 ms a scheduling stall under load could split a
    # queued wave's round on one side only.
    kw.setdefault("max_queue_delay_ms", 1000.0)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 128)
    kw.setdefault("prefill_chunk", 32)
    return cls(**kw)


async def _consume(it):
    out, reason = [], None
    async for ids, reason in it:
        out.extend(ids)
    assert reason in ("stop", "length", "grammar_complete")
    return out


async def _wave(batcher, prompts=WAVE, max_new=6, sampling=None):
    """The whole wave is queued before the loop starts, so every run
    groups its admissions identically."""
    greedy = sampling or (JSampling() if isinstance(batcher, JBatcher)
                          else SamplingConfig())
    its = [batcher.submit(p, max_new, greedy, seed=i)
           for i, p in enumerate(prompts)]
    batcher.start()
    try:
        return await asyncio.gather(*(_consume(it) for it in its))
    finally:
        await batcher.stop()


def _run(engine, cls, **kw):
    batcher = cls(engine, _bcfg(BatchingConfig if cls is ContinuousBatcher
                                else JBatching, **kw))
    return asyncio.run(_wave(batcher)), batcher


@pytest.fixture(scope="module")
def wave_j2(jeng2):
    return _run(jeng2, JBatcher)[0]


@pytest.fixture(scope="module")
def wave_t2(teng2):
    return _run(teng2, ContinuousBatcher)


# -- weights and logits --------------------------------------------------------


def test_params_are_sharded_head_aligned(teng2, teng1):
    layers = teng2.params["layers"]
    assert isinstance(layers["wqkv"], Sharded)
    assert tuple(layers["wqkv"].shape) == tuple(
        teng1.params["layers"]["wqkv"].shape)
    # Shard s holds q heads [4s, 4s+4) and kv heads [2s, 2s+2).
    whole = teng1.params["layers"]["wqkv"]
    hd, h, kvh = CFG.head_dim, CFG.num_heads, CFG.num_kv_heads
    for s, part in enumerate(layers["wqkv"].parts):
        q = whole[..., s * 4 * hd:(s + 1) * 4 * hd]
        k = whole[..., h * hd + s * 2 * hd:h * hd + (s + 1) * 2 * hd]
        v = whole[..., (h + kvh) * hd + s * 2 * hd:
                  (h + kvh) * hd + (s + 1) * 2 * hd]
        assert torch.equal(part, torch.cat([q, k, v], -1))
    # Shards never share storage; the norms are one tensor on one device.
    ptrs = {p.data_ptr() for p in layers["w_down"].parts}
    assert len(ptrs) == 2
    assert layers["attn_norm"].parts[0] is layers["attn_norm"].parts[1]


def test_logits_match_reference_and_tensor1(jeng2, teng1, teng2):
    tokens = np.random.default_rng(0).integers(3, 500, (2, 40)).astype(
        np.int32)
    step = np.array([[17], [29]], np.int32)

    def jrun():
        with jeng2.mesh:
            fwd = jax.jit(jeng2.prefill_forward)
            logits, cache = fwd(jeng2.params, tokens, jeng2.make_cache(2, 64))
            nxt, _ = jax.jit(jeng2.decode_forward)(jeng2.params, step, cache)
        return np.asarray(logits), np.asarray(nxt)

    def trun(eng):
        cache = eng.make_cache(2, 64)
        logits, cache = eng.prefill_forward(eng.params,
                                            torch.from_numpy(tokens), cache)
        nxt, _ = eng.decode_forward(eng.params, torch.from_numpy(step), cache)
        return logits.numpy(), nxt.numpy()

    want = jrun()
    for eng in (teng2, teng1):
        for w, g in zip(want, trun(eng)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    for w, g in zip(trun(teng1), trun(teng2)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_generate_and_stream_match_tensor1(teng1, teng2):
    prompts = [[5, 6, 7], [8, 9, 10, 11]]
    assert teng2.generate(prompts, 8) == teng1.generate(prompts, 8)
    assert list(teng2.generate_stream([3, 4, 5], 6)) == list(
        teng1.generate_stream([3, 4, 5], 6))


# -- greedy streams through the batcher's routes -------------------------------


def test_wave_matches_reference_2dev_and_tensor1(wave_j2, wave_t2, teng1):
    outs, batcher = wave_t2
    assert outs == wave_j2
    assert _run(teng1, ContinuousBatcher)[0] == outs
    assert batcher.fused_admissions > 0 and batcher.chunked_admissions > 0


def test_chunked_and_interleaved_admission(jeng2, teng2):
    """A long prompt admitted mid-decode rides the tick-fused chunk path
    on the mesh; the streams equal the reference's serialized run."""

    async def run(engine, jax_side, mode):
        cls, bcls = ((JBatcher, JBatching) if jax_side
                     else (ContinuousBatcher, BatchingConfig))
        greedy = JSampling() if jax_side else SamplingConfig()
        batcher = cls(engine, _bcfg(bcls, prefill_interleave=mode,
                                    prefill_interleave_rows=2,
                                    decode_steps_per_tick=1,
                                    pipeline_ticks="off"))
        batcher.start()
        try:
            started = asyncio.Event()

            async def first():
                out = []
                async for ids, _ in batcher.submit(SHORT_A, 20, greedy):
                    started.set()
                    out.extend(ids)
                return out

            short = asyncio.create_task(first())
            await started.wait()
            long_out = await _consume(batcher.submit(LONG, 8, greedy))
            return batcher, await short, long_out
        finally:
            await batcher.stop()

    _, j_short, j_long = asyncio.run(run(jeng2, True, "off"))
    b2, t_short, t_long = asyncio.run(run(teng2, False, "on"))
    assert b2.interleaved_admissions == 1
    assert (t_short, t_long) == (j_short, j_long)


def test_paged_arena_on_the_mesh(jeng2, teng2, wave_j2):
    """Pages shard heads over tensor, the block tables ride to each
    shard; same-preamble admissions share pages, and the streams equal
    the reference's paged 2-device run and the contiguous one."""
    outs, batcher = _run(teng2, ContinuousBatcher, paged_kv="on",
                         paged_kv_page_size=8)
    j_outs, j_batcher = _run(jeng2, JBatcher, paged_kv="on",
                             paged_kv_page_size=8)
    assert outs == j_outs == wave_j2
    assert batcher.pages.stats()["paged_prefix_hits"] >= 1
    assert batcher.pages.stats() == j_batcher.pages.stats()
    assert isinstance(batcher.cache.k, Sharded)
    assert batcher.cache.table.shape[1] == 128 // 8


@pytest.fixture(scope="module")
def spec_engines(jparams):
    jeng = JEngine(JCFG, JServing(speculative_draft=NAME), mesh=_jmesh(2),
                   params=jparams)
    teng = GenerationEngine(
        CFG, _serving(2, speculative_draft=NAME), params=_cross(jparams),
        device="cpu", draft_params=_cross(jeng.draft_params))
    return jeng, teng


def test_spec_ticks_with_a_sharded_draft(spec_engines, wave_j2):
    jeng, teng = spec_engines
    assert isinstance(teng.draft_params["layers"]["wqkv"], Sharded)
    assert isinstance(teng.make_draft_cache(2, 16).k, Sharded)
    outs, batcher = _run(teng, ContinuousBatcher, speculative="on")
    j_outs, j_batcher = _run(jeng, JBatcher, speculative="on")
    assert outs == j_outs == wave_j2
    assert batcher.spec_ticks >= 1
    assert (batcher.spec_drafted, batcher.spec_accepted) == (
        j_batcher.spec_drafted, j_batcher.spec_accepted)


def test_tick_failure_replay_rebuilds_the_sharded_cache(jeng2, teng2,
                                                        wave_j2):
    tfail.registry.disarm()
    jfail.registry.disarm()
    try:
        tfail.registry.arm("tick_fail", every=4)
        outs, batcher = _run(teng2, ContinuousBatcher, tick_retry_limit=8)
        tfail.registry.disarm()
        jfail.registry.arm("tick_fail", every=4)
        j_outs, j_batcher = _run(jeng2, JBatcher, tick_retry_limit=8)
    finally:
        tfail.registry.disarm()
        jfail.registry.disarm()
    assert batcher.replayed >= 1 and batcher.replayed == j_batcher.replayed
    assert outs == j_outs == wave_j2


def test_sampled_rows_identical_across_meshes(jeng2, teng1, teng2):
    def run(engine, cls, sampling):
        batcher = cls(engine, _bcfg(BatchingConfig if cls is ContinuousBatcher
                                    else JBatching))
        return asyncio.run(_wave(batcher, [SHORT_B, SHORT_A], 8, sampling))

    t2 = run(teng2, ContinuousBatcher,
             SamplingConfig(temperature=0.7, top_k=8))
    assert t2 == run(teng1, ContinuousBatcher,
                     SamplingConfig(temperature=0.7, top_k=8))
    assert t2 == run(jeng2, JBatcher, JSampling(temperature=0.7, top_k=8))


@pytest.mark.parametrize("serving", [
    {"quantize": "int8"}, {"kv_cache_dtype": "int8"},
    {"quantize": "int8", "kv_cache_dtype": "int8"},
], ids=["int8_weights", "int8_kv", "int8_both"])
def test_int8_on_the_mesh_matches_tensor1(jparams, serving):
    outs = []
    for tensor in (1, 2):
        eng = GenerationEngine(CFG, _serving(tensor, **serving),
                               params=_cross(jparams), device="cpu")
        outs.append(_run(eng, ContinuousBatcher)[0])
    assert outs[0] == outs[1]


def test_synthetic_int8_weights_shard_like_their_whole_draw():
    """Synthetic int8 weights are drawn whole from the seed and then
    sharded (q and scale by `quantize_specs`): tensor=2 serves the
    tokens tensor=1 does."""
    outs = []
    for tensor in (1, 2):
        eng = GenerationEngine(CFG, _serving(
            tensor, quantize="int8", synthetic_weights=True), seed=3,
            device="cpu")
        outs.append(_run(eng, ContinuousBatcher)[0])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("jump_max", [0, 8], ids=["masked", "jump"])
def test_grammar_ticks_on_the_mesh_match_tensor1(jparams, jump_max):
    grammar = compile_schema(
        '{"type": "object", "properties": {"a": {"enum": ["x", "yz"]}}, '
        '"required": ["a"]}', vocab_size=CFG.vocab_size)

    def run(tensor):
        engine = GenerationEngine(
            CFG, _serving(tensor, grammar=GrammarConfig(jump_max=jump_max)),
            params=_cross(jparams), device="cpu")
        batcher = ContinuousBatcher(engine, _bcfg(BatchingConfig))

        async def go():
            its = [batcher.submit([3, 1, 4], 24, SamplingConfig(),
                                  grammar=grammar),
                   batcher.submit(SHORT_A, 6, SamplingConfig())]
            batcher.start()
            try:
                return await asyncio.gather(*(_consume(i) for i in its))
            finally:
                await batcher.stop()

        return asyncio.run(go()), batcher

    (t1, _), (t2, b2) = run(1), run(2)
    assert t1 == t2
    assert b2.grammar_tokens > 0
    if jump_max:
        assert b2.grammar_jump_tokens > 0


# -- mesh identity and downgrades ----------------------------------------------


def test_mesh_stats_at_one_device_match_reference(jparams, teng1):
    """`mesh_shape` is "single" at one device, as the reference's."""
    jeng1 = JEngine(JCFG, JServing(), mesh=_jmesh(1), params=jparams)
    jstats = JBatcher(jeng1, _bcfg(JBatching)).stats()
    tstats = ContinuousBatcher(teng1, _bcfg(BatchingConfig)).stats()
    assert {k: tstats[k] for k in MESH_KEYS} == {
        k: jstats[k] for k in MESH_KEYS}
    assert tstats["mesh_shape"] == "single"
    serving_pb2.ServingStatsResponse(**tstats)
    info, jinfo = teng1.model_info(), jeng1.model_info()
    assert (info["mesh"], info["num_devices"]) == (
        jinfo["mesh"], jinfo["num_devices"]) == ({}, 1)


def test_mesh_stats_at_tensor2_match_reference(jeng2, teng2):
    assert teng2.mesh_stats() == jeng2.mesh_stats() == {
        "tp_chips": 2, "mesh_devices": 2, "mesh_shape": "tensor=2",
        "mesh_spec_downgrades": 0}
    stats = ContinuousBatcher(teng2, _bcfg(BatchingConfig)).stats()
    serving_pb2.ServingStatsResponse(**stats)
    info, jinfo = teng2.model_info(), jeng2.model_info()
    for key in ("mesh", "num_devices", "num_params_million"):
        assert info[key] == jinfo[key]


def test_downgrade_counted_where_the_reference_counts(jparams, teng1):
    """tiny-llama's 4 KV heads cannot split over tensor=8: the cache
    spec downgrades (counted once per site, as the reference's); every
    shard holds all KV heads and reads its query heads' groups."""
    jeng = JEngine(JCFG, JServing(), mesh=jmesh.build_mesh(
        JMesh(tensor=8, data=1), jax.devices()[:8]), params=jparams)
    teng = GenerationEngine(CFG, _serving(8), params=_cross(jparams),
                            device="cpu")
    assert teng.spec_downgrades == jeng.spec_downgrades == 0
    jeng.make_cache(2, 64)
    cache = teng.make_cache(2, 64)
    teng.make_cache(2, 64)
    assert teng.spec_downgrades == jeng.spec_downgrades >= 1
    assert teng.mesh_stats() == jeng.mesh_stats()
    assert cache.k.factors[-2] == 1
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(3, 500, (2, 24)).astype(np.int32))
    want, _ = teng1.prefill_forward(teng1.params, tokens,
                                    teng1.make_cache(2, 64))
    got, _ = teng.prefill_forward(teng.params, tokens, cache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("heads,kv_heads,tensor,want", [
    (8, 4, 8, [(0,), (0,), (1,), (1,), (2,), (2,), (3,), (3,)]),
    (32, 8, 16, [(i // 2,) for i in range(16)]),
    (16, 2, 4, [(0,), (0,), (1,), (1,)]),
    (12, 4, 3, [(0, 0, 0, 1), (1, 2), (2, 3, 3, 3)]),
    (28, 4, 7, [(0,), (0, 0, 0, 1), (1,), (1, 2), (2,), (2, 3, 3, 3),
                (3,)]),
])
def test_shard_kv_heads(heads, kv_heads, tensor, want):
    """A replicated-KV shard reads its query heads' groups: one GQA
    block (query head j on block head j // (H/t / n)) where they form
    one, else one KV head per query head."""
    cfg = dataclasses.replace(CFG, num_heads=heads, num_kv_heads=kv_heads)
    assert [tl.shard_kv_heads(cfg, tensor, i)
            for i in range(tensor)] == want


def test_replicated_kv_per_query_head_matches_tensor1():
    """12 query heads over 4 KV heads at tensor=3 (a head of 48, so the
    fused wqkv's columns split by 3): shards 0 and 2 read one gathered KV
    head per query head, shard 1 a block of two. Prefill
    and a cached decode step within 1e-4 of tensor=1."""
    cfg = dataclasses.replace(CFG, num_heads=12, num_kv_heads=4,
                              head_dim=48, vocab_size=510, ffn_dim=768)
    one = GenerationEngine(cfg, _serving(1), device="cpu",
                           params=tl.init_params(cfg, CPU, seed=11))
    three = GenerationEngine(cfg, _serving(3), device="cpu",
                             params=tl.init_params(cfg, CPU, seed=11))
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(3, 500, (2, 24)).astype(np.int32))
    step = tokens[:, :1]
    c1, c3 = one.make_cache(2, 64), three.make_cache(2, 64)
    assert three.spec_downgrades >= 1
    for toks in (tokens, step):
        want, _ = one.prefill_forward(one.params, toks, c1)
        got, _ = three.prefill_forward(three.params, toks, c3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


def test_query_heads_must_split(jparams, teng1):
    """8 query heads do not split over tensor=16: the attention block is
    held whole on every shard (the reference splits wqkv's 512 columns,
    32 a shard: ROADMAP §C), which counts no site; the FFN and the
    vocabulary still split. Logits within 1e-4 of tensor=1's."""
    teng = GenerationEngine(CFG, _serving(16), params=_cross(jparams),
                            device="cpu")
    assert teng.spec_downgrades == 0
    layers = teng.params["layers"]
    assert layers["wqkv"].factors[-1] == layers["wo"].factors[-2] == 1
    assert layers["w_down"].factors[-2] == 16
    assert teng.params["lm_head"].factors[-1] == 16
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(3, 500, (2, 24)).astype(np.int32))
    want, _ = teng1.prefill_forward(teng1.params, tokens,
                                    teng1.make_cache(2, 64))
    got, _ = teng.prefill_forward(teng.params, tokens, teng.make_cache(2, 64))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# -- the routes served on a mesh ---------------------------------------------

REFUSED = {
    "lora": dict(lora=LoraConfig(adapters=["a"])),
    "kv_ring": dict(model="tiny-mistral", kv_ring=True),
    "kv_tiers": dict(batching=BatchingConfig(kv_tiers=[[64, 2], [128, 2]],
                                             kv_cache_max_seq=128)),
    "host_tier": dict(batching=BatchingConfig(
        paged_kv="on", paged_kv_host_bytes=1 << 20)),
    "role": dict(role="prefill", batching=BatchingConfig(paged_kv="on")),
    "embed": dict(model="bert-tiny"),
    "expert_on_dense": dict(mesh=MeshConfig(tensor=1, expert=2)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_routes_raise_at_construction(name):
    """The routes ROADMAP A18b once refused on a mesh start at tensor=2
    (their parity with the JAX package: tests/test_torch_mesh_routes.py);
    an expert axis on a dense model still raises."""
    kw = dict(REFUSED[name])
    mesh = kw.pop("mesh", MeshConfig(tensor=2))
    if name == "expert_on_dense":
        with pytest.raises(ValueError, match="needs a MoE model"):
            Sidecar(ServingConfig(mesh=mesh, **kw), device="cpu")
        return
    side = Sidecar(ServingConfig(mesh=mesh, **kw), device="cpu")
    engine = side.generation or side.embedding
    assert engine.mesh.shape["tensor"] == 2
    if side.batcher is not None:
        assert side.batcher.stats()["mesh_shape"] == "tensor=2"


async def test_page_transfer_on_a_mesh_raises_typed(teng2, teng1):
    """Page export and import on a tensor-sharded arena (once a typed
    refusal): the codec's whole heads out of the tensor=2 arena, into a
    tensor=1 one, bit for bit, and the decode leg's tokens equal a mixed
    replica's."""
    cfg = _bcfg(BatchingConfig, paged_kv="on", paged_kv_page_size=8)
    src, dst, mixed = (ContinuousBatcher(e, cfg)
                       for e in (teng2, teng1, teng2))
    for b in (src, dst, mixed):
        b.start()
    try:
        await _consume(src.submit(PRE, 1, SamplingConfig()))
        export = await src.run_host_op(lambda: src.export_prompt_kv(PRE))
        assert export["k"].shape == (CFG.num_layers, 3, 8, CFG.num_kv_heads,
                                     CFG.head_dim)
        placed = await dst.run_host_op(lambda: dst.import_prompt_kv(
            PRE, 0, export["k"], export["v"]))
        assert placed == (3, 0)
        again = dst._gather_pages(dst.pages.chain_pages(PRE))
        assert torch.equal(again["k"], export["k"])
        got = await _consume(dst.submit(PRE, 6, SamplingConfig()))
        want = await _consume(mixed.submit(PRE, 6, SamplingConfig()))
    finally:
        for b in (src, dst, mixed):
            await b.stop()
    assert got == want
    with pytest.raises(KVTransferError, match="no indexed pages"):
        src.export_prompt_kv([1, 2, 3])


# -- the sidecar over gRPC -----------------------------------------------------


async def _sidecar_fields(side):
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    try:
        def rpc(method, req, resp):
            return channel.unary_unary(
                method, request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString)

        gen = await rpc("/ggrmcp.tpu.GenerateService/Generate",
                        serving_pb2.GenerateRequest,
                        serving_pb2.GenerateResponse)(
            serving_pb2.GenerateRequest(prompt="the quick", max_new_tokens=4,
                                        return_tokens=True))
        stats = await rpc("/ggrmcp.tpu.ModelInfoService/GetServingStats",
                          serving_pb2.ServingStatsRequest,
                          serving_pb2.ServingStatsResponse)(
            serving_pb2.ServingStatsRequest())
        info = await rpc("/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                         serving_pb2.ModelInfoRequest,
                         serving_pb2.ModelInfoResponse)(
            serving_pb2.ModelInfoRequest())
    finally:
        await channel.close()
        await side.stop()
    return (list(gen.token_ids), {k: getattr(stats, k) for k in MESH_KEYS},
            dict(info.mesh), info.num_devices)


@pytest.mark.parametrize("tensor", [1, 2])
async def test_sidecar_mesh_fields_match_reference(jparams, tensor):
    """GetServingStats' and GetModelInfo's mesh fields on the wire in the
    reference's values and formats ("single", "tensor=2"), each sidecar
    generating on its mesh (the reference's on its own random weights)."""
    batching = dict(max_batch_size=4, kv_cache_max_seq=128)
    jside = JSidecar(JServing(model=NAME, batching=JBatching(**batching)),
                     mesh=_jmesh(tensor))
    tside = Sidecar(_serving(tensor, model=NAME,
                             batching=BatchingConfig(**batching)),
                    params=_cross(jparams), device="cpu")
    want = await _sidecar_fields(jside)
    got = await _sidecar_fields(tside)
    assert got[1:] == want[1:]
    assert got[1]["mesh_shape"] == ("tensor=2" if tensor == 2 else "single")
    assert got[1]["mesh_spec_downgrades"] == 0
    assert len(got[0]) > 0 and len(want[0]) > 0


def test_meshconfig_fields_match_reference():
    assert [f.name for f in dataclasses.fields(MeshConfig)] == [
        f.name for f in dataclasses.fields(JMesh)]
    assert tmesh.AXES == jmesh.AXES
