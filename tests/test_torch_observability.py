"""The flight recorder in the port's batcher against the JAX package's:
the same tiny-llama weights, float32, greedy, one seeded request
sequence (fused and chunked admissions, a constrained request, a
stream). Request records agree field for field apart from wall-clock
fields and the histogram counts are equal; every tick's phases close on
its duration; the stats() keys are the reference's minus the unported
features'; observability off records nothing; and the unchanged
gateway's /metrics in front of a port sidecar carries the latency
histograms.
"""

import asyncio
import dataclasses

import aiohttp
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.grammar import compile_schema as j_compile
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    ObservabilityConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.flight_recorder import PHASE_NAMES
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests.test_grammar_jump import SCHEMAS
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
VOCAB = tl.CONFIGS["tiny-llama"].vocab_size
CFG = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
           max_queue_delay_ms=1000.0)
# stats() keys of the reference batcher the port does not export (none
# since speculative ticks were ported).
UNPORTED_STATS = set()
# Record fields that must agree (the rest are wall-clock stamps, or tick
# numbers).
RECORD_FIELDS = ("tokens", "prompt_tokens", "finish_reason", "constrained",
                 "tenant", "qos_class", "trace_id")
REQUEST_HISTOGRAMS = ("ttft_ms", "e2e_ms", "queue_ms", "tpot_ms")


@pytest.fixture(scope="module")
def engines():
    cfg = jl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JEngine(
        cfg, JServing(mesh=MeshConfig(tensor=1)),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
        params=jparams,
    )
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"], device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), CPU))
    return jeng, teng


def serving_view(engine, **changes):
    """The engine with other serving settings, for batchers built over
    it (they read engine.serving at construction); the engine itself is
    shared and not changed."""
    serving = dataclasses.replace(engine.serving, **changes)

    class _View:
        def __getattr__(self, name):
            return getattr(engine, name)

    view = _View()
    view.__dict__["serving"] = serving
    return view


def _sequence():
    """(prompt, max_new, schema or None, stream, tenant, qos_class)."""
    rng = np.random.default_rng(7)
    return [
        (rng.integers(3, 500, 5).tolist(), 8, None, False, "acme",
         "interactive"),
        (rng.integers(3, 500, 30).tolist(), 6, None, False, "globex",
         "batch"),
        ([3, 1, 4, 1], 64, SCHEMAS["enum_obj"], False, "acme", "batch"),
        (rng.integers(3, 500, 9).tolist(), 7, None, True, "initech", ""),
        (rng.integers(3, 500, 41).tolist(), 5, None, False, "acme",
         "interactive"),
    ]


async def run_sequence(batcher, reference: bool, requests=None):
    """Submit the sequence at once (one admission round), greedy; each
    request carries trace id r<i>. Returns [(tokens, finish)]."""
    compile_fn = j_compile if reference else compile_schema
    greedy = JSampling() if reference else SamplingConfig()

    async def one(i, prompt, max_new, schema, stream, tenant, qos):
        grammar = None if schema is None else compile_fn(schema,
                                                         vocab_size=VOCAB)
        out, reason = [], None
        async for ids, reason in batcher.submit(
                prompt, max_new, greedy, seed=i, unary=not stream,
                grammar=grammar, trace_id=f"r{i}", tenant=tenant,
                qos_class=qos):
            out.extend(ids)
        return out, reason

    batcher.start()
    try:
        return await asyncio.gather(*(
            one(i, *req) for i, req in enumerate(requests or _sequence())))
    finally:
        await batcher.stop()


def records(batcher) -> dict:
    _, reqs = batcher.flight_snapshot(max_requests=1000)
    return {r.trace_id: {f: getattr(r, f) for f in RECORD_FIELDS}
            for r in reqs}


async def test_records_and_histograms_match_reference(engines):
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**CFG))
    ref = await run_sequence(jb, reference=True)
    tb = ContinuousBatcher(teng, BatchingConfig(**CFG))
    out = await run_sequence(tb, reference=False)
    assert out == ref
    assert tb.fused_admissions > 0 and tb.chunked_admissions > 0
    assert records(tb) == records(jb)
    assert len(records(tb)) == len(_sequence())
    assert any(r["constrained"] for r in records(tb).values())
    t_hist, j_hist = tb.stats(), jb.stats()
    for name in REQUEST_HISTOGRAMS:
        assert t_hist[f"{name}_count"] == j_hist[f"{name}_count"], name
    assert t_hist["ttft_ms_count"] == len(_sequence())
    assert t_hist["latency_bucket_bounds_ms"] == (
        j_hist["latency_bucket_bounds_ms"])
    # One tick schedule in both (one step per tick on the CPU).
    assert t_hist["ticks"] == j_hist["ticks"]
    assert t_hist["tick_duration_ms_count"] == j_hist[
        "tick_duration_ms_count"] == t_hist["ticks"]


async def test_tick_phases_close_on_duration(engines):
    _, teng = engines
    tb = ContinuousBatcher(teng, BatchingConfig(**CFG))
    await run_sequence(tb, reference=False)
    ticks, _ = tb.flight_snapshot(max_ticks=1000)
    assert len(ticks) == tb.stats()["ticks"] > 0
    for t in ticks:
        phases = [getattr(t, f"phase_{p}_ms") for p in PHASE_NAMES]
        assert abs(sum(phases) - t.duration_ms) < 1e-6, t
        assert all(p >= 0.0 for p in phases)
    # The first tick carries the admission round that preceded it.
    assert ticks[0].phase_admit_ms > 0.0 and ticks[0].admitted > 0
    stats = tb.stats()
    total = sum(stats[f"tick_phase_{p}_ms"] for p in PHASE_NAMES)
    assert total == pytest.approx(sum(t.duration_ms for t in ticks),
                                  abs=0.05)
    assert {"r0", "r1"} <= set(ticks[0].trace_ids)


async def test_stats_keys_are_the_reference_minus_unported(engines):
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**CFG))
    tb = ContinuousBatcher(teng, BatchingConfig(**CFG))
    ref_keys, keys = set(jb.stats()), set(tb.stats())
    assert ref_keys - keys == UNPORTED_STATS
    assert keys <= ref_keys
    fields = {f.name for f in serving_pb2.ServingStatsResponse.DESCRIPTOR.fields}
    assert keys <= fields
    serving_pb2.ServingStatsResponse(**tb.stats())


async def test_observability_off_records_nothing(engines):
    _, teng = engines
    view = serving_view(teng, observability=ObservabilityConfig(
        enabled=False))
    tb = ContinuousBatcher(view, BatchingConfig(**CFG))
    on = ContinuousBatcher(teng, BatchingConfig(**CFG))
    out = await run_sequence(tb, reference=False)
    assert out == await run_sequence(on, reference=False)
    ticks, reqs = tb.flight_snapshot()
    assert ticks == [] and reqs == []
    stats = tb.stats()
    assert stats["ttft_ms_count"] == stats["tick_duration_ms_count"] == 0
    assert all(stats[f"tick_phase_{p}_ms"] == 0.0 for p in PHASE_NAMES)
    assert "slo_classes" not in stats and "tenants" not in stats
    assert tb.slo.enabled is False and tb.tenants.enabled is False


async def test_gateway_metrics_carry_port_histograms():
    """The unchanged gateway in front of a port sidecar renders the
    backend's ttft / e2e / queue / tick histograms as a valid exposition,
    as tests/test_observability.py::TestScrapeValidity holds for the JAX
    sidecar."""
    from prometheus_client.parser import text_string_to_metric_families

    from ggrmcp_tpu.gateway.app import Gateway
    from tests.test_gateway_http import gateway_config

    side = Sidecar(ServingConfig(batching=BatchingConfig(**CFG)),
                   device="cpu")
    port = await side.start(0)
    gw = Gateway(gateway_config("aiohttp"), targets=[f"localhost:{port}"])
    await gw.start()
    try:
        async with aiohttp.ClientSession(
                base_url=f"http://127.0.0.1:{gw.port}") as client:
            resp = await client.post("/", json={
                "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                "params": {
                    "name": "ggrmcp_tpu_generateservice_generate",
                    "arguments": {"prompt": "observe me",
                                  "maxNewTokens": 4},
                },
            }, headers={"X-Trace-Id": "trace-port-metrics"})
            assert "error" not in await resp.json()
            text = await (await client.get("/metrics")).text()
    finally:
        await gw.stop()
        await side.stop()
    for base in ("ttft_ms", "e2e_ms", "queue_ms", "tick_duration_ms"):
        assert f"gateway_backend_{base}_bucket" in text, base
    families = {f.name: f for f in text_string_to_metric_families(text)}
    ttft = families["gateway_backend_ttft_ms"]
    assert ttft.type == "histogram"
    count = next(s.value for s in ttft.samples if s.name.endswith("_count"))
    assert count >= 1.0
