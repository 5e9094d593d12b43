"""Speculative decoding inside the port's continuous batcher
(`batching.speculative=on`) and the sidecar's micro-path, against the
JAX package's: the counterparts of `tests/test_spec_batch.py` on one
device (the reference runs a 2-device mesh), with the reference
engine's target and draft weights crossed through `params_from_numpy`,
float32.

- Greedy spec-on equals spec-off and the JAX spec batcher across fused
  (burst and trickle), chunked, prefix-pool and interleaved admission,
  under `tick_fail` replay and after a failed draft admission.
- Constrained and sampled rows give the JAX batcher's tokens.
- The spec_* counters reach ServingStats and the tick records.
- `speculative=on` without a draft runs the plain tick; the config
  refuses what the reference refuses.
- The sidecar: with `speculative=off` and a draft, greedy and plain
  temperature unary calls coalesce in the micro-batcher; top-k, grammar
  and long prompts take the batcher; with `on` everything does.
"""

import asyncio
import json

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
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer
from ggrmcp_tpu_torch.utils import failpoints
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
CFG = jl.CONFIGS["tiny-llama"]
VOCAB = CFG.vocab_size
GREEDY = SamplingConfig(temperature=0.0)
LONG = [(i * 7) % 200 + 3 for i in range(90)]  # > prefill_chunk=32
BURST = [[3, 1, 4, 1], [2, 7, 1], [5, 5, 5, 5, 5], [9, 9]]


@pytest.fixture(scope="module")
def engines():
    mesh = mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])
    jeng = JEngine(CFG, JServing(mesh=MeshConfig(tensor=1),
                                 speculative_draft="tiny-llama"), mesh=mesh)
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"],
        ServingConfig(speculative_draft="tiny-llama"),
        params=params_from_numpy(jax.tree.map(np.asarray, jeng.params), CPU),
        draft_params=params_from_numpy(
            jax.tree.map(np.asarray, jeng.draft_params), CPU),
        device="cpu",
    )
    return jeng, teng


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    yield
    failpoints.registry.disarm()


def _cfg(spec: bool, **kw) -> dict:
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("max_queue_delay_ms", 1000.0)
    return dict(speculative="on" if spec else "off", **kw)


async def _drain(batcher, prompt, max_new, sampling=GREEDY, seed=0,
                 grammar=None):
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, sampling,
                                            seed=seed, grammar=grammar):
        out.extend(ids)
    return out, reason


async def _run_all(batcher, prompts, max_new, sampling=GREEDY):
    batcher.start()
    try:
        return await asyncio.gather(*(
            _drain(batcher, p, max_new, sampling, seed=i)
            for i, p in enumerate(prompts)
        ))
    finally:
        await batcher.stop()


def _port(engines, spec, **kw):
    return ContinuousBatcher(engines[1], BatchingConfig(**_cfg(spec, **kw)))


def _jax(engines, **kw):
    return JBatcher(engines[0], JBatching(**_cfg(True, **kw)))


async def _prefix_waves(batcher, sampling):
    """Wave 1 seeds the prefix pool, wave 2 reuses it."""
    preamble = [(i * 5) % 150 + 3 for i in range(24)]
    batcher.start()
    try:
        seed_wave = await _drain(batcher, preamble + [7, 7], 8, sampling)
        hit_wave = await asyncio.gather(*(
            _drain(batcher, preamble + [9, i], 8, sampling, seed=i)
            for i in range(3)))
    finally:
        await batcher.stop()
    return seed_wave, hit_wave


async def _interleaved(batcher, sampling):
    """A long prompt lands while another slot decodes."""
    batcher.start()
    try:
        bg = asyncio.ensure_future(_drain(batcher, [4, 2, 4], 48, sampling,
                                          seed=1))
        for _ in range(3000):  # until bg decodes (at most 30 s)
            if batcher._active_count():
                break
            await asyncio.sleep(0.01)
        long_res = await _drain(batcher, LONG, 8, sampling, seed=2)
        return await bg, long_res
    finally:
        await batcher.stop()


PFX = dict(prefix_cache_entries=2, prefix_cache_min_seq=8,
           prefix_cache_max_seq=64)
ILV = dict(prefill_chunk=32, prefill_interleave="on",
           prefill_interleave_rows=2, max_queue_delay_ms=5.0)


class TestGreedyIdentity:
    """Greedy spec-on output equals spec-off and the JAX spec batcher on
    every admission route."""

    async def test_fused_burst_and_trickle(self, engines):
        on_b = _port(engines, True)
        on = await _run_all(on_b, BURST, 10)
        assert on == await _run_all(_port(engines, False), BURST, 10)
        assert on == await _run_all(_jax(engines), BURST, 10, JSampling())
        assert on_b.spec_ticks > 0 and on_b.spec_drafted > 0
        assert on_b.fused_admissions == len(BURST)
        one = await _run_all(_port(engines, True), [[8, 6, 7]], 9)
        assert one == await _run_all(_port(engines, False), [[8, 6, 7]], 9)

    async def test_chunked_admission(self, engines):
        on_b = _port(engines, True, prefill_chunk=32)
        on = await _run_all(on_b, [LONG, BURST[0]], 8)
        assert on_b.chunked_admissions == 1
        off = await _run_all(_port(engines, False, prefill_chunk=32),
                             [LONG, BURST[0]], 8)
        ref = await _run_all(_jax(engines, prefill_chunk=32),
                             [LONG, BURST[0]], 8, JSampling())
        assert on == off == ref

    async def test_prefix_pool_admission(self, engines):
        on_b = _port(engines, True, **PFX)
        on = await _prefix_waves(on_b, GREEDY)
        assert on_b.prefix_hits > 0, "prefix path not exercised"
        assert on == await _prefix_waves(_port(engines, False, **PFX),
                                         GREEDY)
        assert on == await _prefix_waves(_jax(engines, **PFX), JSampling())

    async def test_interleaved_admission(self, engines):
        on_b = _port(engines, True, **ILV)
        on = await _interleaved(on_b, GREEDY)
        assert on_b.interleaved_admissions > 0, "interleave not exercised"
        assert on == await _interleaved(_port(engines, False, **ILV), GREEDY)
        assert on == await _interleaved(_jax(engines, **ILV), JSampling())

    async def test_chaos_replay_identity(self, engines):
        """tick_fail every 3rd tick: victims replay with their emitted
        prefix, their draft rows re-prefill at re-admission, and the
        tokens equal the fault-free run."""
        baseline = await _run_all(_port(engines, True), BURST, 8)
        failpoints.registry.arm("tick_fail", every=3)
        chaos_b = _port(engines, True, tick_retry_limit=32)
        faulted = await _run_all(chaos_b, BURST, 8)
        failpoints.registry.disarm()
        assert chaos_b.replayed > 0, "no fault was injected"
        assert chaos_b.replay_exhausted == 0
        assert faulted == baseline

    async def test_failed_draft_admission(self, engines, monkeypatch):
        """A draft admission that fails leaves a zeroed draft pool: the
        rows keep decoding (acceptance only degrades) with spec-off's
        tokens."""
        b = _port(engines, True)
        before = b.dcache
        real = b._spec_admit_impl
        calls = []

        def flaky(*args):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected draft admission failure")
            return real(*args)

        monkeypatch.setattr(b, "_spec_admit_impl", flaky)
        out = await _run_all(b, BURST, 8)
        assert b.dcache is not before and not b._dcache_at_risk
        assert out == await _run_all(_port(engines, False), BURST, 8)


SCHEMA = {
    "type": "object",
    "properties": {
        "ok": {"type": "boolean"},
        "label": {"type": "string", "maxLength": 4},
    },
    "required": ["ok", "label"],
}


async def test_constrained_rows_match(engines):
    """Grammar rows verify under the DFA mask inside the spec tick: the
    tokens are spec-off's and the JAX spec batcher's, and parse."""
    from ggrmcp_tpu.grammar import compile_schema as j_compile

    g = compile_schema(SCHEMA, vocab_size=VOCAB)
    outs = []
    for b in (_port(engines, True), _port(engines, False)):
        b.start()
        try:
            outs.append(await _drain(b, [3, 1, 4, 1], 256, grammar=g))
        finally:
            await b.stop()
    jb = _jax(engines)
    jb.start()
    try:
        outs.append(await _drain(jb, [3, 1, 4, 1], 256, JSampling(),
                                 grammar=j_compile(SCHEMA, vocab_size=VOCAB)))
    finally:
        await jb.stop()
    assert outs[0] == outs[1] == outs[2]
    out, reason = outs[0]
    assert reason in ("grammar_complete", "stop")
    text = ByteTokenizer().decode(out)
    assert json.loads(text)["ok"] in (True, False) and g.matches(text)


async def test_sampled_rows_match_jax(engines):
    """Temperature, top-k and top-p rows in one pool draw the reference's
    streams: 4 of 4 rows equal, draw for draw."""
    rows = [
        (SamplingConfig(temperature=0.9), JSampling(temperature=0.9)),
        (SamplingConfig(temperature=0.8, top_k=5),
         JSampling(temperature=0.8, top_k=5)),
        (SamplingConfig(temperature=1.1, top_p=0.8),
         JSampling(temperature=1.1, top_p=0.8)),
        (GREEDY, JSampling()),
    ]

    async def run(b, k):
        b.start()
        try:
            return await asyncio.gather(*(
                _drain(b, BURST[i], 10, rows[i][k], seed=7 + i)
                for i in range(4)))
        finally:
            await b.stop()

    got = await run(_port(engines, True), 0)
    want = await run(_jax(engines), 1)
    assert sum(g == w for g, w in zip(got, want)) == 4


async def test_stats_and_flight_records(engines):
    b = _port(engines, True)
    await _run_all(b, [[3, 1, 4]], 8)
    stats = b.stats()
    assert stats["spec_ticks"] == b.spec_ticks > 0
    assert stats["spec_drafted"] == 4 * b.spec_ticks
    assert stats["spec_drafted"] >= stats["spec_accepted"] >= 0
    assert stats["memory_draft_cache_bytes"] == (
        b.dcache.k.nbytes + b.dcache.v.nbytes + b.dcache.length.nbytes)
    assert stats["kv_cache_bytes"] > b.cache.k.nbytes + b.cache.v.nbytes
    resp = serving_pb2.ServingStatsResponse(**stats)
    assert resp.spec_ticks == b.spec_ticks
    ticks, _ = b.flight_snapshot(max_ticks=64)
    assert any(t.spec_drafted > 0 for t in ticks)
    assert all(0 <= t.spec_accepted <= t.spec_drafted for t in ticks)
    # One tick advances the step counter by gamma + 1 positions.
    assert stats["decode_steps"] == 5 * b.spec_ticks


def test_spec_without_draft_falls_back():
    eng = GenerationEngine(tl.CONFIGS["tiny-llama"], device="cpu")
    b = ContinuousBatcher(eng, BatchingConfig(speculative="on"))
    assert b._spec is False and b.dcache is None and b._reserve == 0


def test_config_refusals(engines):
    with pytest.raises(ValueError, match="speculative"):
        BatchingConfig(speculative="maybe")
    with pytest.raises(ValueError, match="speculative_gamma"):
        ServingConfig(speculative_gamma=0)
    with pytest.raises(ValueError, match="kv_ring"):
        ServingConfig(model="tiny-mistral", kv_ring=True,
                      batching=BatchingConfig(speculative="on"))
    # A batcher built directly hits the same wall.
    ring = GenerationEngine(
        tl.CONFIGS["tiny-mistral"],
        ServingConfig(model="tiny-mistral", kv_ring=True,
                      speculative_draft="tiny-llama",
                      batching=BatchingConfig(prefill_chunk=8)),
        device="cpu")
    with pytest.raises(ValueError, match="kv_ring"):
        ContinuousBatcher(ring, BatchingConfig(speculative="on",
                                               prefill_chunk=8))
    # The draft's RoPE range clamps the fit limit; the reserve is gamma.
    b = _port(engines, True, kv_cache_max_seq=1024)
    assert b._fit_limit == 1024 and b._reserve == 4 == b._jump_reserve


def _stubs(channel):
    gen = channel.unary_unary(
        "/ggrmcp.tpu.GenerateService/Generate",
        request_serializer=serving_pb2.GenerateRequest.SerializeToString,
        response_deserializer=serving_pb2.GenerateResponse.FromString)
    stats = channel.unary_unary(
        "/ggrmcp.tpu.ModelInfoService/GetServingStats",
        request_serializer=serving_pb2.ServingStatsRequest.SerializeToString,
        response_deserializer=serving_pb2.ServingStatsResponse.FromString)
    return gen, stats


def _req(prompt, **sampling):
    return serving_pb2.GenerateRequest(
        prompt=prompt, max_new_tokens=6, return_tokens=True,
        sampling=serving_pb2.SamplingParams(**sampling))


async def test_sidecar_micro_path_routing(engines):
    """speculative=off with a draft: greedy and plain temperature unary
    calls coalesce in the micro-batcher (fewer calls than requests) with
    the tokens of the engine's generate_speculative; top-k, a grammar and
    a prompt past prefill_chunk take the continuous batcher."""
    _, teng = engines
    serving = ServingConfig(
        speculative_draft="tiny-llama",
        batching=BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                                prefill_chunk=32, max_queue_delay_ms=1000.0))
    side = Sidecar(serving, device="cpu")
    side.generation.params = teng.params
    side.generation.draft_params = teng.draft_params
    assert side.spec_batcher is not None
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    gen, stats_fn = _stubs(channel)
    tok = side.tokenizer
    try:
        prompts = [f"spec {i}" for i in range(4)]
        greedy = await asyncio.gather(*(gen(_req(p)) for p in prompts))
        want, _, _ = teng.generate_speculative(
            [[tok.bos_id] + tok.encode(p) for p in prompts], 6)
        assert [list(r.token_ids) for r in greedy] == want
        s = await stats_fn(serving_pb2.ServingStatsRequest())
        assert s.speculative_requests == 4 > s.speculative_calls >= 1
        assert s.ticks == 0 and s.speculative_drafted > 0
        await gen(_req("warm", temperature=0.7, seed=3))
        s = await stats_fn(serving_pb2.ServingStatsRequest())
        assert s.speculative_requests == 5 and s.ticks == 0
        # Not for the micro-path: top-k, a grammar, a long prompt.
        await gen(_req("topk", temperature=0.7, top_k=5))
        constrained = _req("c")
        constrained.constraint.json_schema = json.dumps({"type": "boolean"})
        await gen(constrained)
        await gen(_req("x" * 40))
        s = await stats_fn(serving_pb2.ServingStatsRequest())
        assert s.speculative_requests == 5 and s.ticks > 0
        assert s.ttft_ms_count == 8  # both paths' histograms merged
        rec = await channel.unary_unary(
            "/ggrmcp.tpu.DebugService/GetFlightRecord",
            request_serializer=(
                serving_pb2.FlightRecordRequest.SerializeToString),
            response_deserializer=serving_pb2.FlightRecordResponse.FromString,
        )(serving_pb2.FlightRecordRequest())
        assert sorted(r.source for r in rec.requests).count("spec") == 5
    finally:
        await channel.close()
        await side.stop()


async def test_sidecar_spec_on_uses_the_batcher():
    side = Sidecar(ServingConfig(
        speculative_draft="tiny-llama",
        batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=256,
                                speculative="on")), device="cpu")
    assert side.spec_batcher is None
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    gen, stats_fn = _stubs(channel)
    try:
        resp = await gen(_req("spec"))
        assert resp.completion_tokens == len(resp.token_ids) <= 6
        s = await stats_fn(serving_pb2.ServingStatsRequest())
        assert s.spec_ticks > 0 and s.spec_drafted > 0
        assert s.speculative_calls == 0
    finally:
        await channel.close()
        await side.stop()
