"""Length tiers (`batching.kv_tiers`, `serving/tiered.py`) over the
port's continuous batcher, against the JAX package's `TieredBatcher`
(the counterpart of `tests/test_tiered.py`): the same tiny-llama weights
crossed through `params_from_numpy`, float32.

- The config checks the reference's tier shapes and order.
- Routing picks the smallest tier that fits prompt + max_new + the tick
  reserve; oversized requests go to the largest tier.
- Mixed-length traffic gives the JAX tiered batcher's tokens, greedy and
  sampled; a long prompt admits chunked inside the long tier.
- Stats sum across tiers (engine-level keys by max), per-tier admissions
  are the routing's, histograms merge; a full tier overflows into a
  larger one and a shed is counted once.
- The sidecar serves through tiers, names each tier's ledger scope, and
  refuses TransferKV imports.
"""

import asyncio

import grpc
import grpc.aio
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.tiered import TieredBatcher as JTiered
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import OverloadedError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.serving.tiered import TieredBatcher
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
TIERS = [[64, 3], [256, 1]]


@pytest.fixture(scope="module")
def engines():
    cfg = jl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JEngine(cfg, JServing(mesh=MeshConfig(tensor=1)),
                   mesh=mesh_mod.build_mesh(MeshConfig(tensor=1),
                                            jax.devices()[:1]),
                   params=jparams)
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"],
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), CPU),
        device="cpu")
    return jeng, teng


@pytest.mark.parametrize("tiers,match", [
    ([[512, 8], [256, 4]], "ascending"),
    ([[512, 8], [512, 4]], "ascending"),
    ([[512, 8, -1], [4096, 2]], "prefix_entries"),
    ([[512]], "max_seq, slots"),
    ([[1, 8], [64, 2]], "smallest tier"),
])
def test_config_rejects_bad_tiers(tiers, match):
    with pytest.raises(ValueError, match=match):
        BatchingConfig(kv_tiers=tiers)


def test_config_accepts_tiers():
    BatchingConfig(kv_tiers=[[512, 8], [4096, 2]])
    BatchingConfig(kv_tiers=[[512, 8, 0], [4096, 2, 4]])
    with pytest.raises(ValueError, match="divide every tier"):
        BatchingConfig(kv_tiers=[[100, 2], [256, 2]], paged_kv="on",
                       kv_cache_max_seq=256)


def test_per_tier_prefix_pool_override(engines):
    tiered = TieredBatcher(engines[1], BatchingConfig(
        kv_tiers=[[64, 4, 0], [256, 4]], prefix_cache_entries=2,
        prefix_cache_min_seq=8, prefix_cache_max_seq=32))
    assert tiered.tiers[0]._pfx_pool is None
    assert tiered.tiers[1]._pfx_pool is not None


def test_kv_bytes_below_flat_pool(engines):
    """Same worst-case request, same slot count: less than half the KV
    of a flat pool at the largest tier's length."""
    cfg = engines[1].cfg
    tiered = TieredBatcher(engines[1], BatchingConfig(kv_tiers=TIERS))
    slots = sum(s for _, s in TIERS)
    flat = 2 * cfg.num_layers * slots * 256 * cfg.num_kv_heads * (
        cfg.head_dim * 4)
    assert tiered.cache_bytes() < flat / 2


def test_routing_picks_smallest_fitting_tier(engines):
    tiered = TieredBatcher(engines[1], BatchingConfig(kv_tiers=TIERS))
    short, long_ = tiered.tiers
    assert tiered._route(10, 16) is short
    assert tiered._route(100, 16) is long_
    assert tiered._route(40, 30) is long_  # 40 + 30 + 1 > 64
    assert tiered._route(1000, 64) is long_  # oversized: the largest
    # The routing equals the JAX facade's.
    jt = JTiered(engines[0], JBatching(kv_tiers=TIERS))
    for n, m in ((10, 16), (63, 0), (62, 1), (100, 16), (1000, 64)):
        assert tiered.tiers.index(tiered._route(n, m)) == jt.tiers.index(
            jt._route(n, m))


# (prompt length, max_new, temperature, seed): both tiers, queueing in
# the 3-slot short tier.
MIX = [(5, 6, 0.0, 1), (8, 4, 0.8, 2), (12, 6, 0.0, 3), (100, 6, 0.0, 4),
       (5, 5, 0.8, 5), (90, 4, 0.8, 6)]


async def _mix(tiered, sampling_cls):
    """The whole mix is queued before the tiers' loops start, so the
    first admission round of each tier sees every request that fits."""
    its = [
        tiered.submit([3 + (seed * 7 + i) % 40 for i in range(n)], m,
                      sampling_cls(temperature=temp, top_k=20 if temp else 0),
                      seed=seed)
        for n, m, temp, seed in MIX
    ]
    tiered.start()

    async def run(it):
        ids, reason = [], None
        async for chunk, reason in it:
            ids.extend(chunk)
        return ids, reason

    try:
        return await asyncio.wait_for(
            asyncio.gather(*(run(it) for it in its)), timeout=120)
    finally:
        await tiered.stop()


async def test_mixed_lengths_match_jax(engines):
    # A round's requests must all be popped within the admission delay:
    # at 2 ms one scheduling stall (a GC pause, a GIL hand-off between
    # the tiers' threads) split the short tier's first round, and a row
    # admitted a tick later draws its sampled tokens at other steps.
    cfg = dict(kv_tiers=TIERS, max_queue_delay_ms=1000.0)
    tiered = TieredBatcher(engines[1], BatchingConfig(**cfg))
    got = await _mix(tiered, SamplingConfig)
    want = await _mix(JTiered(engines[0], JBatching(**cfg)), JSampling)
    assert got == want
    assert all(ids and reason in ("stop", "length") for ids, reason in got)
    # Per tier: the short requests in the short tier, the long ones in
    # the long tier.
    assert [t.timing["admit_rounds"] > 0 for t in tiered.tiers] == [True,
                                                                   True]
    admitted = [t.fused_admissions + t.chunked_admissions
                for t in tiered.tiers]
    assert admitted == [4, 2]


async def test_long_prompt_chunked_into_long_tier(engines):
    prompt = [(i * 7 + 3) % 500 + 1 for i in range(100)]
    want, _ = engines[1].generate([prompt], max_new_tokens=5)
    tiered = TieredBatcher(engines[1], BatchingConfig(
        kv_tiers=TIERS, prefill_chunk=32))
    assert tiered._route(len(prompt), 5) is tiered.tiers[-1]
    tiered.start()
    try:
        out = []
        async for ids, _ in tiered.submit(prompt, 5, SamplingConfig()):
            out.extend(ids)
    finally:
        await tiered.stop()
    assert out == want[0]
    assert tiered.tiers[-1].chunked_admissions == 1


async def test_stats_sum_and_merge(engines):
    tiered = TieredBatcher(engines[1], BatchingConfig(kv_tiers=TIERS))
    await _mix(tiered, SamplingConfig)
    stats = tiered.stats()
    per = [t.counter_stats() for t in tiered.tiers]
    assert stats["total_slots"] == 4
    assert stats["ticks"] == sum(p["ticks"] for p in per) > 0
    assert stats["kv_cache_bytes"] == tiered.cache_bytes()
    assert stats["memory_weights_bytes"] == per[0]["memory_weights_bytes"]
    assert stats["ttft_ms_count"] == len(MIX)
    assert stats["mesh_shape"] == "single"  # the reference's one-device label
    serving_pb2.ServingStatsResponse(**stats)  # every key is a field
    ticks, requests = tiered.flight_snapshot()
    assert {t.source for t in ticks} == {"tier-64", "tier-256"}
    assert len(requests) == len(MIX)


async def test_full_tier_overflows_then_sheds(engines):
    """max_pending 1 a tier (not started: submissions stay queued): the
    second short request spills into the long tier, the third is shed
    once, whichever tiers were probed."""
    tiered = TieredBatcher(engines[1], BatchingConfig(
        kv_tiers=TIERS, max_pending=1))
    tiered.submit([1, 2], 4, SamplingConfig())
    tiered.submit([3, 4], 4, SamplingConfig())
    assert [t.pending.qsize() for t in tiered.tiers] == [1, 1]
    with pytest.raises(OverloadedError):
        tiered.submit([5, 6], 4, SamplingConfig())
    assert tiered.stats()["shed_requests"] == 1
    assert [t.shed for t in tiered.tiers] == [0, 1]


async def test_sidecar_with_tiers():
    side = Sidecar(ServingConfig(batching=BatchingConfig(
        kv_tiers=TIERS, max_queue_delay_ms=2.0)), device="cpu")
    assert isinstance(side.batcher, TieredBatcher)
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    try:
        gen = channel.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateResponse.FromString)
        resp = await gen(serving_pb2.GenerateRequest(
            prompt="tiered", max_new_tokens=5, return_tokens=True))
        assert 0 < resp.completion_tokens <= 5
        memory = await channel.unary_unary(
            "/ggrmcp.tpu.DebugService/GetMemory",
            request_serializer=serving_pb2.MemoryRequest.SerializeToString,
            response_deserializer=serving_pb2.MemoryResponse.FromString,
        )(serving_pb2.MemoryRequest())
        scopes = {(c.scope, c.component) for c in memory.components}
        assert {("tier-64", "kv_arena"), ("tier-256", "kv_arena")} <= scopes
        transfer = channel.unary_unary(
            "/ggrmcp.tpu.KVTransferService/TransferKV",
            request_serializer=serving_pb2.KVTransferRequest.SerializeToString,
            response_deserializer=serving_pb2.KVTransferResponse.FromString)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            await transfer(serving_pb2.KVTransferRequest(
                prompt_ids=[1, 2, 3], page_size=16))
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        await channel.close()
        await side.stop()
