"""Every serving feature at once: the port's counterpart of
`tests/test_composition.py` (int8 weights, the int8 KV cache, length
tiers, the prefix pool and a speculative draft on one sidecar at
tensor=2, driven over gRPC) and of
`tests/test_kv_quant.py::test_speculative_composes_with_int8`, held to
the JAX package on the same weights: the reference's tiny-llama target
(a dense init tree) and its sidecar's draft, crossed through
`params_from_numpy`, float32.

- The reference's `maximal_serving()` parses in the port's config, and
  the port refuses each composition the reference refuses, with the same
  message.
- The maximal sidecar of each package gets `test_composition.py`'s five
  calls and the greedy repeat: every token equal, greedy and sampled
  (the port's threefry is bit for bit, so sampled rows match draw for
  draw). The two long sampled calls go to the long tier one after the
  other: a tier's draws fold in its tick step, so two rows of one tier
  match draw for draw only when their admission ticks do, which
  concurrent arrival over gRPC leaves to chance in either package.
  `GetServingStats`: the reference's slots, speculative requests, decode
  steps and prefix hits; `kv_cache_bytes` the reference's plus the
  port's scratch position in each cache (ROADMAP.md §C, recorded
  divergences).
- `generate_speculative` equals `generate` within the int8 config, and
  both equal the JAX engine, at tensor 1 and 2.
- The spec tick (`batching.speculative=on`) on the int8 cache gives
  spec-off's tokens and the JAX engine's; under `tick_fail` every third
  tick the replayed rows give the unarmed run's tokens.
"""

import asyncio
import dataclasses

import grpc
import grpc.aio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.rpc.pb import serving_pb2 as jpb
from ggrmcp_tpu.serving import sidecar as jsidecar
from ggrmcp_tpu_torch.core import config as tcfg
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2 as tpb
from ggrmcp_tpu_torch.serving import sidecar as tsidecar
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.utils import failpoints
from tests import torch_threads  # noqa: F401
from tests.test_composition import maximal_serving

CPU = torch.device("cpu")
NAME = "tiny-llama"
LONG = "shared system preamble " * 4  # past the prefix pool's minimum
# test_kv_quant.py's prompts, and a burst for the spec tick.
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6]]
BURST = [[3, 1, 4, 1], [2, 7, 1], [5, 5, 5, 5, 5], [9, 9], [8, 6, 4, 2, 1]]
NEW = 10
SPEC_SMALL = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=32)


def _port_serving(serving=None) -> tcfg.ServingConfig:
    """The reference's ServingConfig, as its dict, through the port's
    config file parser."""
    data = dataclasses.asdict(serving or maximal_serving())
    return tcfg.config_from_dict({"serving": data}).serving


async def _traffic(side, pb) -> dict:
    """test_composition.py's calls over gRPC: two greedy and one sampled
    short call (the micro-path) beside the two long sampled calls (the
    long tier, the second a prefix hit), then the greedy repeat and
    GetServingStats."""
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    try:
        gen = channel.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.GenerateResponse.FromString)

        async def call(prompt, temperature):
            resp = await gen(pb.GenerateRequest(
                prompt=prompt, max_new_tokens=5, return_tokens=True,
                sampling=pb.SamplingParams(temperature=temperature,
                                           seed=7)))
            return (list(resp.token_ids), resp.finish_reason,
                    resp.completion_tokens, resp.model_id)

        async def long_pair():
            return [await call(LONG + "q1", 0.9),
                    await call(LONG + "q2", 0.9)]

        *short, pair = await asyncio.gather(
            call("greedy one", 0.0), call("greedy two", 0.0),
            call("sampled", 0.9), long_pair())
        again = await call("greedy one", 0.0)
        stats = await channel.unary_unary(
            "/ggrmcp.tpu.ModelInfoService/GetServingStats",
            request_serializer=pb.ServingStatsRequest.SerializeToString,
            response_deserializer=pb.ServingStatsResponse.FromString,
        )(pb.ServingStatsRequest())
    finally:
        await channel.close()
        await side.stop()
    return dict(calls=short + pair, again=again, stats=stats)


def _spec_serving(tensor: int) -> tcfg.ServingConfig:
    return tcfg.ServingConfig(
        quantize="int8", kv_cache_dtype="int8", speculative_draft=NAME,
        mesh=tcfg.MeshConfig(tensor=tensor))


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the maximal sidecar on a tensor=2 mesh over
    the dense init tree (the reference's sidecar builds its engine with
    these weights in place of its own init), its traffic, and its
    engine's plain and speculative greedy tokens."""
    cfg = jl.CONFIGS[NAME]
    dense = jl.init_params(jax.random.PRNGKey(0), cfg)
    build = jsidecar.GenerationEngine
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsidecar, "GenerationEngine", lambda *a, **kw: build(
            *a, **{**kw, "params": jax.tree.map(jnp.array, dense)}))
        side = jsidecar.Sidecar(maximal_serving(), mesh=jmesh.build_mesh(
            JMesh(tensor=2), jax.devices()[:2]))
    engine = side.generation
    draft = jax.tree.map(np.asarray, engine.draft_params)
    # No warmup: each program compiles at its first use (its tokens are
    # the same), not also at the warmup's shapes.
    side.batcher.warmup = engine.warmup_speculative = lambda: None
    traffic = asyncio.run(_traffic(side, jpb))
    # One batch for both prompt sets (one compile): greedy rows do not
    # depend on their batch.
    plain, reasons = engine.generate(PROMPTS + BURST, max_new_tokens=NEW,
                                     seed=0)
    spec, _, spec_stats = engine.generate_speculative(PROMPTS,
                                                      max_new_tokens=NEW)
    n = len(PROMPTS)
    return dict(dense=jax.tree.map(np.asarray, dense), draft=draft,
                traffic=traffic, plain=plain[:n], plain_reasons=reasons[:n],
                spec=spec, spec_rounds=spec_stats["rounds"], burst=plain[n:],
                cache_scratch=_scratch_bytes(side.batcher))


def _scratch_bytes(tiered) -> int:
    """Bytes of one more position in each of the reference's caches
    (every tier's pool and prefix pool): the port's scratch slot."""
    total = 0
    for tier in tiered.tiers:
        for cache in (tier.cache, tier._pfx_pool):
            for leaf in (cache.k, cache.v):
                total += (leaf.q.nbytes + leaf.scale.nbytes) // \
                    leaf.q.shape[2]
    return total


def _params(ref):
    return params_from_numpy(ref["dense"], CPU)


def _draft(ref):
    return params_from_numpy(ref["draft"], CPU)


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    yield
    failpoints.registry.disarm()


# -- (a) the config -----------------------------------------------------------


def test_maximal_config_parses_as_in_the_reference():
    ref = jcfg.default()
    ref.serving = maximal_serving()
    ref.validate()
    ours = _port_serving()
    assert dataclasses.asdict(ours.batching) == dataclasses.asdict(
        ref.serving.batching)
    assert (ours.quantize, ours.kv_cache_dtype, ours.speculative_draft) == (
        "int8", "int8", NAME)
    assert (ours.mesh.tensor, ours.mesh.data) == (2, 0)


# Compositions of the maximal config that the reference refuses:
# (serving fields, batching fields).
REFUSED = [
    ({"kv_ring": True}, {}),
    ({"kv_ring": True}, {"speculative": "on"}),
    ({"role": "prefill"}, {}),
    ({}, {"paged_kv": "on"}),
    ({"quantize": "int4"}, {}),
    ({"kv_cache_dtype": "fp8"}, {}),
    ({"speculative_gamma": 0}, {}),
    ({}, {"kv_tiers": [[256, 2], [64, 3]]}),
    ({}, {"prefix_cache_min_seq": 0}),
    ({}, {"prefix_cache_max_seq": 4}),
    ({}, {"prefix_cache_entries": -1}),
]


@pytest.mark.parametrize("serving,batching", REFUSED,
                         ids=[str({**s, **b}) for s, b in REFUSED])
def test_refusals_match_the_reference(serving, batching):
    with pytest.raises(ValueError) as want:
        base = maximal_serving()
        mutated = dataclasses.replace(
            base, batching=dataclasses.replace(base.batching, **batching),
            **serving)
        cfg = jcfg.default()
        cfg.serving = mutated
        cfg.validate()
    data = dataclasses.asdict(maximal_serving())
    data.update(serving)
    data["batching"].update(batching)
    with pytest.raises(ValueError) as got:
        tcfg.config_from_dict({"serving": data})
    assert str(got.value) == str(want.value)


# -- (b) the maximal sidecar over gRPC ------------------------------------------


async def test_maximal_sidecar_matches_the_reference(ref):
    build = tsidecar.GenerationEngine
    draft = _draft(ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsidecar, "GenerationEngine", lambda *a, **kw: build(
            *a, **{**kw, "draft_params": draft}))
        side = tsidecar.Sidecar(_port_serving(), params=_params(ref),
                                device="cpu")
    assert side.spec_batcher is not None
    assert type(side.batcher).__name__ == "TieredBatcher"
    assert side.generation.mesh.shape["tensor"] == 2
    got = await _traffic(side, tpb)
    want = ref["traffic"]
    assert got["calls"] == want["calls"]
    assert got["again"] == want["again"] == got["calls"][0]
    for ids, finish, completion, model in got["calls"]:
        assert finish in ("length", "stop") and 0 < completion <= 5
        assert len(ids) == completion and model == NAME
    stats, jstats = got["stats"], want["stats"]
    assert stats.total_slots == jstats.total_slots == 5
    assert stats.kv_cache_bytes == jstats.kv_cache_bytes + \
        ref["cache_scratch"]
    assert stats.speculative_requests == jstats.speculative_requests >= 3
    assert stats.decode_steps == jstats.decode_steps >= 1
    assert stats.prefix_cache_hits == jstats.prefix_cache_hits >= 1


# -- (c) speculative decoding on int8 caches ----------------------------------


@pytest.mark.parametrize("tensor", [1, 2])
def test_speculative_composes_with_int8(ref, tensor):
    eng = GenerationEngine(tl.CONFIGS[NAME], _spec_serving(tensor),
                           params=_params(ref), draft_params=_draft(ref),
                           device="cpu")
    assert eng.mesh.shape["tensor"] == tensor and eng.use_flash is False
    plain, reasons = eng.generate(PROMPTS, max_new_tokens=NEW, seed=0)
    spec, _, stats = eng.generate_speculative(PROMPTS, max_new_tokens=NEW)
    assert spec == plain == ref["plain"] == ref["spec"]
    assert reasons == ref["plain_reasons"]
    assert stats["rounds"] == ref["spec_rounds"] >= 1


# -- (d) the spec tick on the int8 cache ----------------------------------------


async def _burst(batcher) -> list:
    async def one(prompt):
        out = []
        async for ids, _ in batcher.submit(prompt, NEW, SamplingConfig()):
            out.extend(ids)
        return out

    batcher.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*(one(p) for p in BURST)), timeout=120)
    finally:
        await batcher.stop()


async def test_spec_tick_on_the_int8_cache(ref):
    eng = GenerationEngine(tl.CONFIGS[NAME], _spec_serving(1),
                           params=_params(ref), draft_params=_draft(ref),
                           device="cpu")

    def batcher(spec, **extra):
        return ContinuousBatcher(eng, tcfg.BatchingConfig(
            speculative=spec, **SPEC_SMALL, **extra))

    on_b = batcher("on")
    on = await _burst(on_b)
    assert on_b.spec_ticks > 0 and on_b.dcache is not None
    assert type(on_b.cache.k).__name__ == "QuantizedTensor"
    assert type(on_b.dcache.k).__name__ == "QuantizedTensor"
    assert on == await _burst(batcher("off")) == ref["burst"]
    failpoints.registry.arm("tick_fail", every=3)
    chaos = batcher("on", tick_retry_limit=32)
    faulted = await _burst(chaos)
    failpoints.registry.disarm()
    assert chaos.replayed > 0, "no fault was injected"
    assert chaos.replay_exhausted == 0
    assert faulted == on
