"""The host page tier (batching.paged_kv_host_bytes) in the port's
batcher against the JAX package's, held to `tests/test_host_pool.py`:
the same tiny-llama weights, float32, greedy.

- Every admission route under arena pressure (fused, paged prefix,
  chunked; the interleave), restore failures (`host_restore_fail`, a
  typed recompute), a tick failure's replay, int8 pages: the port's
  tokens equal the JAX batcher's, and its demotion, restore and byte
  counters are the JAX batcher's.
- The 10x thrash bound: at ten times the arena's working set the host
  tier serves >= 0.9 of re-visited preamble pages without recompute.
- Exports and invariant audits racing admissions through `run_host_op`
  lose no page.
- A warm restart from the file tier, within the port and across the
  packages (a file either package wrote restores in the other: the page
  codec and the geometry signature are the reference's).
- Preemption with the tier attached: a parked victim's pages demote,
  the resume restores them, tokens equal the uninterrupted run's.
- The stats, GetMemory's host section, the config checks.
"""

import asyncio
import contextlib

import aiohttp
import grpc
import pytest

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    SchedulerConfig,
    ServingConfig,
    serving_config_from_dict,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, KVTransferError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import failpoints
from tests.test_torch_observability import engines, serving_view  # noqa: F401
from tests import torch_threads  # noqa: F401

HOST_KEYS = (
    "kv_host_demotions", "kv_host_restores", "kv_host_bytes_demoted",
    "kv_host_bytes_restored", "kv_host_restore_failures",
    "kv_host_entries", "kv_host_bytes_used", "kv_host_budget_bytes",
    "paged_prefix_hits", "paged_pages_reused", "paged_pages_admitted",
    "kv_pages_in_use", "shed_requests", "prefix_cache_hits",
)


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    jfail.registry.disarm()
    yield
    failpoints.registry.disarm()
    jfail.registry.disarm()


def host_cfg(**kw) -> dict:
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("kv_cache_max_seq", 128)
    kw.setdefault("paged_kv", "on")
    kw.setdefault("paged_kv_page_size", 8)
    kw.setdefault("paged_kv_pages", 16)
    kw.setdefault("paged_kv_host_bytes", 64 << 20)
    return kw


def prompt_of(n: int, salt: int = 0) -> list[int]:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


async def collect(batcher, prompt, max_new, seed=0, reference=False,
                  **kw):
    out: list[int] = []
    reason = None
    greedy = JSampling(temperature=0.0) if reference else SamplingConfig()
    async for ids, r in batcher.submit(prompt, max_new, greedy, seed=seed,
                                       **kw):
        out.extend(ids)
        reason = r
    return out, reason


async def run_wave(batcher, prompts, max_new=4, sequential=True,
                   reference=False):
    """(outputs, counters taken before stop: stop closes the file
    tier)."""
    batcher.start()
    try:
        if sequential:
            results = [await collect(batcher, p, max_new, seed=i,
                                     reference=reference)
                       for i, p in enumerate(prompts)]
        else:
            results = await asyncio.gather(*(
                collect(batcher, p, max_new, seed=i, reference=reference)
                for i, p in enumerate(prompts)))
        stats = (batcher.counter_stats() if reference
                 else batcher.stats())
    finally:
        await batcher.stop()
    for out, reason in results:
        assert reason in ("stop", "length") and out
    return [out for out, _ in results], stats


async def both(engines, cfg: dict, prompts, **kw):  # noqa: F811
    """The prompts through the JAX batcher and the port's: identical
    tokens, identical host-tier and paged counters."""
    jeng, teng = engines
    ref, ref_stats = await run_wave(JBatcher(jeng, JBatching(**cfg)),
                                    prompts, reference=True, **kw)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out, stats = await run_wave(tb, prompts, **kw)
    assert out == ref
    assert {k: stats[k] for k in HOST_KEYS} == {
        k: ref_stats[k] for k in HOST_KEYS}
    tb.pages.check_invariants()
    return out, stats, tb


async def test_all_admission_paths_match_reference(engines):  # noqa: F811
    """Fused (short cold), paged prefix (shared preamble) and chunked
    (long cold) admissions under arena pressure, with real demotions and
    restores; equal to the paged-only run too."""
    prompts = (
        [prompt_of(32, salt=s) + [400 + s] for s in range(4)] * 2
        + [prompt_of(80, salt=9)] + [prompt_of(12, salt=50)]
    )
    out, stats, _ = await both(engines, host_cfg(prefill_chunk=32), prompts)
    assert stats["kv_host_demotions"] > 0 and stats["kv_host_restores"] > 0
    _, teng = engines
    plain, _ = await run_wave(ContinuousBatcher(teng, BatchingConfig(
        **host_cfg(prefill_chunk=32, paged_kv_host_bytes=0))), prompts)
    assert out == plain


async def test_interleaved_admission_matches_reference(engines):  # noqa: F811
    """Long prompts arriving while a short one decodes ride the
    interleave on an arena under pressure."""
    jeng, teng = engines
    cfg = host_cfg(prefill_chunk=32, prefill_interleave="on",
                   paged_kv_pages=40, max_batch_size=4)
    outs = []
    for batcher, ref in ((JBatcher(jeng, JBatching(**cfg)), True),
                         (ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          False)):
        batcher.start()
        try:
            warm = [await collect(batcher, prompt_of(32, salt=s) + [9], 2,
                                  reference=ref) for s in range(4)]
            started = asyncio.Event()

            async def short():
                out = []
                greedy = JSampling() if ref else SamplingConfig()
                async for ids, _ in batcher.submit([5, 6, 7], 24, greedy):
                    started.set()
                    out.extend(ids)
                return out

            task = asyncio.create_task(short())
            await started.wait()
            longs = await asyncio.gather(*(
                collect(batcher, prompt_of(100, salt=7 + i), 5, seed=i,
                        reference=ref) for i in range(2)))
            stats = (batcher.counter_stats() if ref else batcher.stats())
            outs.append((warm + [await task] + longs, stats))
        finally:
            await batcher.stop()
    (ref_out, ref_stats), (out, stats) = outs
    assert out == ref_out
    assert stats["interleaved_admissions"] == ref_stats[
        "interleaved_admissions"] == 2
    assert stats["kv_host_demotions"] == ref_stats["kv_host_demotions"] > 0


async def test_restore_failures_stay_identical(engines):  # noqa: F811
    """host_restore_fail: every second restore dies; the admission
    recomputes typed (counted) and the tokens never change."""
    prompts = [prompt_of(32, salt=s) + [400 + s] for s in range(5)] * 2
    jfail.registry.arm("host_restore_fail", every=2, times=4)
    failpoints.registry.arm("host_restore_fail", every=2, times=4)
    out, stats, _ = await both(engines, host_cfg(), prompts)
    assert stats["kv_host_restore_failures"] >= 1
    assert stats["kv_host_restores"] >= 1
    failpoints.registry.disarm()
    _, teng = engines
    clean, _ = await run_wave(ContinuousBatcher(
        teng, BatchingConfig(**host_cfg())), prompts)
    assert out == clean


async def test_tick_failure_replay_restores(engines):  # noqa: F811
    """A failed tick resets the allocator and rebuilds the arena, but
    the host pool survives: replays and later admissions restore."""
    prompts = [prompt_of(32, salt=s) + [400 + s] for s in range(4)]
    cfg = host_cfg(tick_retry_limit=3)
    _, teng = engines
    clean, _ = await run_wave(ContinuousBatcher(
        teng, BatchingConfig(**cfg)), prompts)
    jfail.registry.arm("tick_fail", every=4, times=2)
    failpoints.registry.arm("tick_fail", every=4, times=2)
    out, stats, _ = await both(engines, cfg, prompts)
    assert out == clean
    assert stats["replayed_requests"] >= 1


async def test_int8_kv_pages_demote_and_restore(engines):  # noqa: F811
    """int8 arena pages demote and restore with their scales."""
    jeng, teng = engines
    int8 = (
        JEngine(jeng.cfg, JServing(mesh=MeshConfig(tensor=1),
                                   kv_cache_dtype="int8"),
                mesh=jeng.mesh, params=jeng.params),
        GenerationEngine(tl.CONFIGS["tiny-llama"],
                         ServingConfig(kv_cache_dtype="int8"),
                         params=teng.params, device="cpu"),
    )
    prompts = [prompt_of(32, salt=s) + [400 + s] for s in range(4)] * 2
    _, stats, tb = await both(int8, host_cfg(), prompts)
    assert stats["kv_host_restores"] > 0
    assert tb.cache.k.q.dtype.is_floating_point is False


class TestThrash10x:
    N_PREAMBLES = 40  # x 4 pages each = 160 pages = 10x the 16-page arena

    async def _effective_rate(self, teng, host_on: bool):
        cfg = host_cfg() if host_on else host_cfg(paged_kv_host_bytes=0)
        batcher = ContinuousBatcher(teng, BatchingConfig(**cfg))
        pres = [prompt_of(32, salt=100 + s) for s in range(self.N_PREAMBLES)]
        batcher.start()
        try:
            await asyncio.gather(*(
                collect(batcher, pre + [400 + s], 2, seed=s)
                for s, pre in enumerate(pres)))
            st0 = batcher.stats()
            await asyncio.gather(*(
                collect(batcher, pre + [700 + s], 2, seed=s)
                for s, pre in enumerate(pres)))
            st1 = batcher.stats()
            batcher.pages.check_invariants()
        finally:
            await batcher.stop()
        served = (st1["paged_pages_reused"] - st0["paged_pages_reused"]
                  + st1["kv_host_restores"] - st0["kv_host_restores"])
        return served / (self.N_PREAMBLES * 4)

    async def test_host_tier_holds_effective_hit_rate(self, engines):  # noqa: F811
        _, teng = engines
        assert await self._effective_rate(teng, host_on=False) < 0.5
        assert await self._effective_rate(teng, host_on=True) >= 0.9


async def test_exports_racing_admissions_lose_no_page(engines):  # noqa: F811
    """Exports and allocator audits through run_host_op interleave with
    admissions (restores and demotions); every audit passes and every
    output equals the JAX batcher's."""
    jeng, teng = engines
    pre = prompt_of(32, salt=77)
    prompts = [pre + [500 + i] for i in range(6)] + [
        prompt_of(32, salt=200 + i) + [i] for i in range(6)]
    ref, _ = await run_wave(JBatcher(jeng, JBatching(**host_cfg())),
                            prompts, max_new=3, sequential=False,
                            reference=True)
    batcher = ContinuousBatcher(teng, BatchingConfig(**host_cfg()))
    batcher.start()
    audits = {"n": 0, "pages": 0}
    stop = asyncio.Event()

    async def churn():
        while not stop.is_set():
            with contextlib.suppress(KVTransferError):
                export = await batcher.run_host_op(
                    lambda: batcher.export_prompt_kv(pre))
                audits["pages"] += export["pages"]
            await batcher.run_host_op(batcher.pages.check_invariants)
            audits["n"] += 1
            await asyncio.sleep(0)

    task = asyncio.ensure_future(churn())
    try:
        results = await asyncio.gather(*(
            collect(batcher, p, 3, seed=i) for i, p in enumerate(prompts)))
    finally:
        stop.set()
        with contextlib.suppress(Exception):
            await asyncio.wait_for(task, timeout=30)
        await batcher.stop()
    assert [out for out, _ in results] == ref
    assert audits["n"] >= 1
    batcher.pages.check_invariants()


@pytest.mark.parametrize("writer", ["port", "reference"])
async def test_warm_restart_from_file_tier(engines, tmp_path, writer):  # noqa: F811
    """A brand-new port batcher (cold RAM pool, cold arena) on the file
    tier a previous batcher of either package wrote restores instead of
    recomputing, with the same tokens."""
    jeng, teng = engines
    cfg = host_cfg(paged_kv_host_path=str(tmp_path / "warm.kv"))
    prompts = [prompt_of(32, salt=s) + [400 + s] for s in range(5)]
    if writer == "port":
        first, stats1 = await run_wave(
            ContinuousBatcher(teng, BatchingConfig(**cfg)), prompts)
    else:
        first, stats1 = await run_wave(
            JBatcher(jeng, JBatching(**cfg)), prompts, reference=True)
    assert stats1["kv_host_file_entries"] > 0
    again, stats2 = await run_wave(
        ContinuousBatcher(teng, BatchingConfig(**cfg)), prompts)
    assert again == first
    assert stats2["kv_host_restores"] > 0


async def test_reference_restores_from_port_file(engines, tmp_path):  # noqa: F811
    jeng, teng = engines
    cfg = host_cfg(paged_kv_host_path=str(tmp_path / "warm.kv"))
    prompts = [prompt_of(32, salt=s) + [400 + s] for s in range(5)]
    first, _ = await run_wave(ContinuousBatcher(teng, BatchingConfig(**cfg)),
                              prompts)
    again, stats = await run_wave(JBatcher(jeng, JBatching(**cfg)), prompts,
                                  reference=True)
    assert again == first and stats["kv_host_restores"] > 0


def test_page_geometry_is_the_references(engines):  # noqa: F811
    jeng, teng = engines
    for kv in ("", "int8"):
        cfg = host_cfg()
        jb = JBatcher(
            JEngine(jeng.cfg, JServing(mesh=MeshConfig(tensor=1),
                                       kv_cache_dtype=kv),
                    mesh=jeng.mesh, params=jeng.params),
            JBatching(**cfg))
        tb = ContinuousBatcher(
            GenerationEngine(tl.CONFIGS["tiny-llama"],
                             ServingConfig(kv_cache_dtype=kv),
                             params=teng.params, device="cpu"),
            BatchingConfig(**cfg))
        assert tb._kv_page_geometry() == jb._kv_page_geometry()


async def test_preemption_parks_on_the_host_and_resume_restores(
        engines):  # noqa: F811
    """A victim's pages demote at preemption; the interactive request's
    admission evicts them from the 12-page arena; the resume restores
    them. Tokens equal the uninterrupted runs and the JAX batcher's;
    the sched_* and host counters agree."""
    jeng, teng = engines
    cfg = host_cfg(max_batch_size=1, paged_kv_pages=12)
    vp, ip = prompt_of(40, salt=5), prompt_of(56, salt=6)
    sched = dict(enabled=True, preempt_wait_fraction=1e-6)

    async def solo(prompt, n, **kw):
        b = ContinuousBatcher(teng, BatchingConfig(**cfg))
        b.start()
        try:
            return await collect(b, prompt, n, **kw)
        finally:
            await b.stop()

    base = [await solo(vp, 12, qos_class="background"),
            await solo(ip, 8, qos_class="interactive")]
    outs = []
    from ggrmcp_tpu.core.config import SchedulerConfig as JScheduler
    for ref in (True, False):
        if ref:
            batcher = JBatcher(serving_view(
                jeng, scheduler=JScheduler(**sched)), JBatching(**cfg))
        else:
            batcher = ContinuousBatcher(serving_view(
                teng, scheduler=SchedulerConfig(**sched)),
                BatchingConfig(**cfg))
        batcher.start()
        try:
            loop = asyncio.get_running_loop()
            first = loop.create_future()

            async def victim():
                out, reason = [], None
                greedy = JSampling() if ref else SamplingConfig()
                async for ids, reason in batcher.submit(
                        vp, 12, greedy, qos_class="background"):
                    out.extend(ids)
                    if not first.done():
                        first.set_result(None)
                return out, reason

            task = asyncio.ensure_future(victim())
            await asyncio.wait_for(first, timeout=120)
            got_i = await collect(batcher, ip, 8, reference=ref,
                                  qos_class="interactive")
            got_v = await task
            stats = (batcher.counter_stats() if ref else batcher.stats())
            outs.append(([got_v, got_i], stats))
        finally:
            await batcher.stop()
    (ref_out, ref_stats), (out, stats) = outs
    assert out == ref_out == base
    keys = HOST_KEYS + ("sched_preemptions", "sched_resumes",
                        "sched_parked")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert stats["sched_preemptions"] >= 1 and stats["sched_resumes"] >= 1
    assert stats["kv_host_demotions"] >= 1 and stats["kv_host_restores"] >= 1


async def test_stats_proto_and_debug_memory_host_section(engines):  # noqa: F811
    """ServingStats carries the kv_host_* fields; GetMemory over gRPC has
    the host pool as its `host` section, budget and entries included,
    and the unchanged gateway's /debug/memory and /metrics show it."""
    _, teng = engines
    prompts = [prompt_of(32, salt=s) + [s] for s in range(5)] * 2
    tb = ContinuousBatcher(teng, BatchingConfig(**host_cfg()))
    _, stats = await run_wave(tb, prompts)
    msg = serving_pb2.ServingStatsResponse(**stats)
    assert msg.kv_host_budget_bytes == 64 << 20
    assert msg.kv_host_demotions > 0 and msg.kv_host_restores > 0
    assert msg.kv_host_bytes_demoted > 0 and msg.kv_host_bytes_restored > 0
    from ggrmcp_tpu.gateway.app import Gateway
    from tests.test_gateway_http import gateway_config

    side = Sidecar(serving_config_from_dict({"serving": {
        "model": "tiny-llama", "batching": host_cfg()}}), device="cpu")
    port = await side.start(0)
    gw = Gateway(gateway_config("aiohttp"), targets=[f"localhost:{port}"])
    await gw.start()
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            memory = await ch.unary_unary(
                "/ggrmcp.tpu.DebugService/GetMemory",
                request_serializer=serving_pb2.MemoryRequest.SerializeToString,
                response_deserializer=serving_pb2.MemoryResponse.FromString,
            )(serving_pb2.MemoryRequest())
        async with aiohttp.ClientSession(
                base_url=f"http://127.0.0.1:{gw.port}") as client:
            body = await (await client.get("/debug/memory")).json()
            metrics = await (await client.get("/metrics")).read()
    finally:
        await gw.stop()
        await side.stop()
    [host] = memory.host
    assert host.component == "host_pool" and host.entries == 0
    assert host.budget_bytes == 64 << 20 and memory.host_total_bytes == 0
    # The unchanged gateway renders it as /debug/memory's host section.
    [backend] = body["backends"]
    [section] = backend["host"]
    assert section["component"] == "host_pool"
    assert int(section["budgetBytes"]) == 64 << 20
    assert b"gateway_backend_kv_host_budget_bytes{" in metrics


@pytest.mark.parametrize("kw,match", [
    (dict(paged_kv="on", paged_kv_host_bytes=-1), "paged_kv_host_bytes"),
    (dict(paged_kv_host_bytes=1 << 20), "requires paged_kv"),
    (dict(paged_kv="on", paged_kv_host_path="x.kv"), "paged_kv_host_bytes"),
    (dict(paged_kv="on", paged_kv_host_bytes=1,
          paged_kv_host_file_bytes=5), "paged_kv_host_path"),
    (dict(paged_kv="on", paged_kv_host_bytes=1, paged_kv_host_path="x",
          paged_kv_host_file_bytes=-1), "paged_kv_host_file_bytes"),
])
def test_host_tier_config_checks_match_reference(kw, match):
    """The port's checks refuse what the reference's Config.validate
    refuses, naming the field."""
    from ggrmcp_tpu.core.config import Config

    cfg = Config()
    for key, value in kw.items():
        setattr(cfg.serving.batching, key, value)
    with pytest.raises(ValueError, match=match):
        cfg.validate()
    with pytest.raises(ValueError, match=match):
        BatchingConfig(**kw)
    ok = BatchingConfig(paged_kv="on", paged_kv_host_bytes=1 << 20,
                        paged_kv_host_path="x.kv",
                        paged_kv_host_file_bytes=1 << 30)
    assert ok.paged_kv_host_path == "x.kv"
