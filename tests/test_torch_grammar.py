"""Schema-constrained decoding in the PyTorch port against the reference
(`ggrmcp_tpu/grammar`, the JAX batcher and sidecar), on the CPU.

- compiler: the port's copy gives tables byte-equal to the reference's
  for every schema of tests/test_grammar.py's suite and of
  tests/test_grammar_jump.py's, at tiny-llama's vocabulary and, for two
  of them, at llama3-8b's 128,256 tokens; the same typed errors;
- arena: state-0 reservation and relocation, refcounts and idle
  eviction, the capacity error, and the batcher's device tables equal
  to the host arena through acquire, release and eviction churn;
- batcher: constrained greedy AND sampled tokens identical to the JAX
  batcher's (tiny-llama, float32, the same weights) through fused,
  chunked and paged admission with jump-ahead on (the default), and
  greedy through the interleave; unconstrained rows of a mixed batch
  equal their solo runs;
- sidecar: the constraint surface (valid JSON, stats, stream, typed
  INVALID_ARGUMENT and RESOURCE_EXHAUSTED);
- gateway: one structured-output `tools/call` through the unchanged
  reference gateway returns the same `tokenIds` from the port's sidecar
  as from the JAX sidecar.
"""

import asyncio
import contextlib
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
from ggrmcp_tpu.grammar import GrammarError as JGrammarError
from ggrmcp_tpu.grammar import compile_schema as j_compile
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    GrammarConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.grammar import (
    GrammarArena,
    GrammarCache,
    GrammarCapacityError,
    GrammarError,
    SchemaTooComplexError,
    SchemaUnsupportedError,
    compile_schema,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer
from tests.test_grammar import SUITE, validate
from tests.test_grammar_jump import SCHEMAS as JUMP_SCHEMAS
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
TOK = ByteTokenizer()
VOCAB = tl.CONFIGS["tiny-llama"].vocab_size
LLAMA3_VOCAB = tl.CONFIGS["llama3-8b"].vocab_size
ALL_SCHEMAS = {**SUITE, **{f"jump_{k}": v for k, v in JUMP_SCHEMAS.items()}}
TABLES = ("allow", "trans", "sink", "accept", "jump_len", "jump_tokens",
          "jump_states")


def _text(ids) -> str:
    return TOK.decode(ids)


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


def _assert_tables_equal(schema, vocab):
    ref = j_compile(schema, vocab_size=vocab)
    out = compile_schema(schema, vocab_size=vocab)
    assert (out.n_states, out.start, out.eos_id, out.schema_hash) == (
        ref.n_states, ref.start, ref.eos_id, ref.schema_hash)
    for name in TABLES:
        a, b = getattr(out, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("name", sorted(ALL_SCHEMAS))
def test_tables_byte_equal_to_reference(name):
    _assert_tables_equal(ALL_SCHEMAS[name], VOCAB)


@pytest.mark.parametrize("name", ["enum", "jump_const_obj"])
def test_tables_byte_equal_at_llama3_vocab(name):
    _assert_tables_equal(ALL_SCHEMAS[name], LLAMA3_VOCAB)


@pytest.mark.parametrize("schema,error", [
    ({"type": "array"}, SchemaUnsupportedError),
    ({"type": "string", "pattern": "a+"}, SchemaUnsupportedError),
    ({"type": "frobnicate"}, SchemaUnsupportedError),
    ({}, SchemaUnsupportedError),
    ("{not json", GrammarError),
    ({"$ref": "#/definitions/N", "definitions": {"N": {
        "type": "object", "properties": {"n": {"$ref": "#/definitions/N"}},
        "required": ["n"]}}}, SchemaTooComplexError),
])
def test_typed_errors_as_reference(schema, error):
    with pytest.raises(error) as out:
        compile_schema(schema, vocab_size=VOCAB)
    with pytest.raises(JGrammarError) as ref:
        j_compile(schema, vocab_size=VOCAB)
    assert type(out.value).__name__ == type(ref.value).__name__


def test_cache_compiles_once_then_hits():
    cache = GrammarCache(max_entries=2)
    g1 = cache.get({"type": "boolean"}, vocab_size=VOCAB)
    assert cache.get('{"type":"boolean"}', vocab_size=VOCAB) is g1
    cache.get({"type": "null"}, vocab_size=VOCAB)
    cache.get({"type": "integer"}, vocab_size=VOCAB)  # evicts boolean
    cache.get({"type": "boolean"}, vocab_size=VOCAB)
    assert (cache.compiles, cache.hits) == (4, 1)


# ---------------------------------------------------------------------------
# Arena
# ---------------------------------------------------------------------------


def test_arena_state0_reserved_and_relocation():
    g = compile_schema(SUITE["enum"], vocab_size=VOCAB)
    arena = GrammarArena(256, VOCAB, jump_max=8)
    handle = arena.acquire(g)
    assert handle.base >= 1 and bool(arena.allow[0].all())
    s_abs, s_loc = handle.start, g.start
    for t in TOK.encode('"beta"'):
        s_abs, s_loc = arena.step(s_abs, t), g.step(s_loc, t)
    assert s_abs == s_loc + handle.base
    assert arena.is_sink(s_abs) == bool(g.sink[s_loc])
    # The forced run from the start state (the opening quote), relocated.
    assert arena.forced_run(handle.start) == g.forced_run(g.start)


def test_arena_refcount_idle_eviction_and_capacity():
    small = GrammarArena(80, VOCAB)
    g_live = compile_schema({"type": "null"}, vocab_size=VOCAB)
    g_idle = compile_schema({"type": "boolean"}, vocab_size=VOCAB)
    h_live = small.acquire(g_live)
    h_idle = small.acquire(g_idle)
    used = small.states_in_use()
    small.release(h_idle)  # idle but resident
    assert small.states_in_use() == used
    small.acquire(compile_schema({"type": "string", "maxLength": 4},
                                 vocab_size=VOCAB))
    assert g_idle.schema_hash not in small._entries
    assert g_live.schema_hash in small._entries
    small.release(h_live)
    tiny = GrammarArena(12, VOCAB)
    tiny.acquire(g_idle)  # 10 states, live
    with pytest.raises(GrammarCapacityError):
        tiny.acquire(g_live)


def _device_tables_equal(batcher):
    a = batcher.arena
    host = (a.allow, a.trans, a.jump_len, a.jump_tokens, a.jump_states)
    for dev, ref in zip(batcher._grammar_device_tables(), host):
        assert dev.shape == ref.shape
        np.testing.assert_array_equal(dev.cpu().numpy(), ref)


def test_device_tables_follow_arena_churn(tiny_engine):
    """Only the rows an insert wrote are uploaded; through acquires,
    releases and evictions the device tables stay equal to the host
    arena. Before the first grammar they are the one-state tables."""
    batcher = ContinuousBatcher(tiny_engine, BatchingConfig(
        max_batch_size=2, kv_cache_max_seq=64))
    batcher.arena = GrammarArena(150, VOCAB, jump_max=8)
    batcher._g_dev_version = batcher.arena.version
    batcher._grammar_tables()
    assert batcher._g_allow.shape == (1, VOCAB)
    names = ["enum", "object_required", "array", "nested"]
    grammars = [compile_schema(SUITE[n], vocab_size=VOCAB) for n in names]
    handles = []
    for g in grammars[:2]:
        handles.append(batcher.arena.acquire(g))
        batcher._grammar_tables()
        _device_tables_equal(batcher)
    for h in handles:
        batcher.arena.release(h)
    for g in grammars[2:] + grammars[:1]:  # evicts idle rows, reuses them
        batcher.arena.release(batcher.arena.acquire(g))
    batcher._grammar_tables()
    _device_tables_equal(batcher)
    assert batcher.grammar_table_bytes() == 150 * VOCAB * 5 + 150 * 4 * 17


# ---------------------------------------------------------------------------
# Batcher parity with the JAX batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), jl.CONFIGS["tiny-llama"])
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def engines(weights):
    jparams, tparams = weights
    jeng = JEngine(
        jl.CONFIGS["tiny-llama"], JServing(mesh=MeshConfig(tensor=1)),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
        params=jparams,
    )
    teng = GenerationEngine(tl.CONFIGS["tiny-llama"], params=tparams,
                            device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def tiny_engine(weights):
    return GenerationEngine(tl.CONFIGS["tiny-llama"], params=weights[1],
                            device="cpu")


# (prompt, schema name or None, (temperature, top_k, top_p), seed, max_new)
MIXED = [
    ([3, 1, 4, 1], "object_required", (0.0, 0, 1.0), 0, 256),
    ([7, 7, 7], "nested", (1.0, 0, 0.9), 11, 256),
    ([5, 5, 5], "array", (0.0, 0, 1.0), 2, 256),
    ([9, 2], "enum", (0.8, 20, 1.0), 3, 256),
    ([1, 2, 3], None, (0.0, 0, 1.0), 4, 8),
    ([4, 2], "number", (0.0, 0, 1.0), 5, 256),
    ([2, 2], "jump_const_obj", (0.7, 0, 0.9), 6, 256),
    (list(range(3, 93)), "jump_nested", (0.0, 0, 1.0), 7, 256),
]
ROUTES = {
    "fused": dict(max_batch_size=8, kv_cache_max_seq=512),
    "chunked": dict(max_batch_size=8, kv_cache_max_seq=512, prefill_chunk=32),
    "paged": dict(max_batch_size=8, kv_cache_max_seq=512, paged_kv="on",
                  paged_kv_page_size=16),
}


async def _drain(batcher, prompt, max_new, sampling, **kw):
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, sampling, **kw):
        out.extend(ids)
    return out, reason


async def _run_set(batcher, requests, compile_fn, sampling_cls):
    """Every request of the set submitted at once (one admission round,
    hence the same tick sequence on both sides)."""
    batcher.start()
    try:
        return await asyncio.gather(*(
            _drain(batcher, prompt, max_new, sampling_cls(*samp), seed=seed,
                   grammar=None if name is None else compile_fn(
                       ALL_SCHEMAS[name], vocab_size=VOCAB))
            for prompt, name, samp, seed, max_new in requests))
    finally:
        await batcher.stop()


def _check_valid(results, requests):
    for (out, reason), (_, name, *_rest) in zip(results, requests):
        if name is None:
            continue
        assert reason in ("grammar_complete", "stop"), (name, reason)
        assert validate(json.loads(_text(out)), ALL_SCHEMAS[name]), name


@pytest.mark.parametrize("route", sorted(ROUTES))
async def test_batcher_matches_reference(engines, route):
    """Greedy and sampled constrained rows, one unconstrained rider, a
    long prompt (chunked under prefill_chunk=32): the port's tokens
    equal the JAX batcher's, with jump-ahead on both sides."""
    jeng, teng = engines
    cfg = dict(ROUTES[route], max_queue_delay_ms=1000.0)
    ref = await _run_set(JBatcher(jeng, JBatching(**cfg)), MIXED, j_compile,
                         JSampling)
    port = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out = await _run_set(port, MIXED, compile_schema, SamplingConfig)
    assert out == ref
    _check_valid(out, MIXED)
    stats = port.stats()
    assert stats["grammar_jump_runs"] > 0
    assert stats["grammar_masked_tokens"] >= sum(
        len(o) for (o, _), r in zip(out, MIXED) if r[1] is not None)
    # Every arena reference came back at the terminal chunk.
    assert all(e["refs"] == 0 for e in port.arena._entries.values())
    if route == "chunked":
        assert port.chunked_admissions > 0 and port.fused_admissions > 0
    if route == "fused":
        # The unconstrained rider equals its solo run.
        solo = await _run_set(ContinuousBatcher(teng, BatchingConfig(**cfg)),
                              [MIXED[4]], compile_schema, SamplingConfig)
        assert solo[0] == out[4]


async def test_interleaved_admission_matches_reference(engines):
    """A constrained long prompt admitted mid-decode through the
    interleave equals its solo chunked run and the JAX batcher's."""
    jeng, teng = engines
    name, prompt = "nested", list(range(5, 95))
    cfg = dict(max_batch_size=4, kv_cache_max_seq=512, prefill_chunk=32)
    solo = await _run_set(ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          [(prompt, name, (0.0, 0, 1.0), 0, 256)],
                          compile_schema, SamplingConfig)

    async def interleaved(batcher, compile_fn, sampling_cls):
        batcher.start()
        try:
            bg = asyncio.create_task(
                _drain(batcher, [8, 8, 8], 120, sampling_cls(), seed=1))
            while batcher.stats()["active_slots"] == 0:
                await asyncio.sleep(0.005)
            out = await _drain(
                batcher, prompt, 256, sampling_cls(),
                grammar=compile_fn(ALL_SCHEMAS[name], vocab_size=VOCAB))
            return out, await bg
        finally:
            await batcher.stop()

    ilv = dict(cfg, prefill_interleave="on", prefill_interleave_rows=2)
    ref = await interleaved(JBatcher(jeng, JBatching(**ilv)), j_compile,
                            JSampling)
    port = ContinuousBatcher(teng, BatchingConfig(**ilv))
    out = await interleaved(port, compile_schema, SamplingConfig)
    assert port.interleaved_admissions >= 1
    assert out[0] == solo[0] == ref[0]
    assert out[1] == ref[1]
    _check_valid([out[0]], [(prompt, name)])


async def test_capacity_shed_is_eager_and_typed(tiny_engine):
    batcher = ContinuousBatcher(
        tiny_engine, BatchingConfig(max_batch_size=2, kv_cache_max_seq=128))
    batcher.arena = GrammarArena(40, VOCAB)
    with pytest.raises(GrammarCapacityError):
        batcher.submit([1, 2], 8, SamplingConfig(),
                       grammar=compile_schema(SUITE["nested"],
                                              vocab_size=VOCAB))
    assert batcher.pending.empty()


def test_constrained_prompt_clamped_as_reference(engines):
    """Only a grammar-carrying request reserves the jump window: near the
    cache's end its prompt is clamped exactly as the reference clamps
    it, an unconstrained one keeps the plain reserve."""
    jeng, teng = engines
    cfg = dict(max_batch_size=2, kv_cache_max_seq=64)
    port = ContinuousBatcher(teng, BatchingConfig(**cfg))
    ref = JBatcher(jeng, JBatching(**cfg))
    g = compile_schema(SUITE["enum"], vocab_size=VOCAB)
    jg = j_compile(SUITE["enum"], vocab_size=VOCAB)
    prompt = list(range(3, 63))
    for grammar, jgrammar in ((g, jg), (None, None)):
        port.submit(prompt, 10, SamplingConfig(), grammar=grammar)
        want = ref.clamp_prompt(prompt, 10, constrained=grammar is not None)
        assert port.pending._items[-1].prompt == want
    assert port._jump_reserve == ref._jump_reserve == 8
    assert port._reserve == ref._reserve == 0


# ---------------------------------------------------------------------------
# Sidecar
# ---------------------------------------------------------------------------


def _unary(channel, method, req_cls, resp_cls):
    return channel.unary_unary(method,
                               request_serializer=req_cls.SerializeToString,
                               response_deserializer=resp_cls.FromString)


@contextlib.asynccontextmanager
async def _sidecar(params, **serving_kw):
    side = Sidecar(ServingConfig(
        batching=BatchingConfig(max_batch_size=4, kv_cache_max_seq=512),
        **serving_kw), params=params, device="cpu")
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    try:
        yield side, channel
    finally:
        await channel.close()
        await side.stop()


def _constraint(schema) -> serving_pb2.ConstraintSpec:
    return serving_pb2.ConstraintSpec(
        json_schema=schema if isinstance(schema, str) else json.dumps(schema))


async def test_sidecar_serves_constraints(weights):
    schema = SUITE["object_required"]
    async with _sidecar(weights[1]) as (side, channel):
        gen = _unary(channel, "/ggrmcp.tpu.GenerateService/Generate",
                     serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        stats_rpc = _unary(
            channel, "/ggrmcp.tpu.ModelInfoService/GetServingStats",
            serving_pb2.ServingStatsRequest, serving_pb2.ServingStatsResponse)
        resp = await gen(serving_pb2.GenerateRequest(
            prompt="hi", max_new_tokens=256, constraint=_constraint(schema)))
        assert resp.finish_reason in ("grammar_complete", "stop")
        assert validate(json.loads(resp.text), schema)
        stats = await stats_rpc(serving_pb2.ServingStatsRequest())
        assert stats.grammar_compiles == 1 and stats.grammar_cache_hits == 0
        assert stats.grammar_masked_tokens > 0
        assert stats.grammar_states_in_use > 1
        assert stats.memory_grammar_arena_bytes > 0
        await gen(serving_pb2.GenerateRequest(
            prompt="yo", max_new_tokens=256, constraint=_constraint(schema)))
        stats = await stats_rpc(serving_pb2.ServingStatsRequest())
        assert stats.grammar_compiles == 1 and stats.grammar_cache_hits == 1
        # A stream with a constraint.
        stream = channel.unary_stream(
            "/ggrmcp.tpu.GenerateService/GenerateStream",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateChunk.FromString)
        text, finish = "", ""
        async for chunk in stream(serving_pb2.GenerateRequest(
                prompt="s", max_new_tokens=256,
                constraint=_constraint(SUITE["array"]))):
            text += chunk.text_delta
            if chunk.done:
                finish = chunk.finish_reason
        assert finish in ("grammar_complete", "stop")
        assert validate(json.loads(text), SUITE["array"])


@pytest.mark.parametrize("constraint", [
    _constraint('{"type":"string","pattern":"a+"}'),
    _constraint("{not json"),
    serving_pb2.ConstraintSpec(tool_output_schema_ref="some_tool"),
], ids=["unsupported", "unparsable", "unresolved_ref"])
async def test_sidecar_bad_constraint_is_invalid_argument(weights, constraint):
    async with _sidecar(weights[1]) as (_, channel):
        gen = _unary(channel, "/ggrmcp.tpu.GenerateService/Generate",
                     serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            await gen(serving_pb2.GenerateRequest(
                prompt="x", max_new_tokens=4, constraint=constraint))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


class _SubwordTokenizer(ByteTokenizer):
    """Stands for a tokenizer the DFA cannot align with (not a
    ByteTokenizer as far as the sidecar's check goes)."""


async def test_sidecar_refuses_without_byte_tokenizer_or_when_disabled(
        weights, monkeypatch):
    async with _sidecar(weights[1]) as (side, channel):
        gen = _unary(channel, "/ggrmcp.tpu.GenerateService/Generate",
                     serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        monkeypatch.setattr(
            "ggrmcp_tpu_torch.serving.sidecar.ByteTokenizer",
            _SubwordTokenizer)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            await gen(serving_pb2.GenerateRequest(
                prompt="x", max_new_tokens=4,
                constraint=_constraint(SUITE["enum"])))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "byte-level tokenizer" in err.value.details()
    async with _sidecar(weights[1], grammar=GrammarConfig(enabled=False)) as (
            side, channel):
        gen = _unary(channel, "/ggrmcp.tpu.GenerateService/Generate",
                     serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            await gen(serving_pb2.GenerateRequest(
                prompt="x", max_new_tokens=4,
                constraint=_constraint(SUITE["enum"])))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert side.batcher.arena.max_states == 2


async def test_sidecar_full_arena_is_resource_exhausted(weights):
    """An arena too small for two live schemas: the second distinct
    schema is refused RESOURCE_EXHAUSTED while the first decodes."""
    a = compile_schema(SUITE["nested"], vocab_size=VOCAB)
    b = compile_schema(SUITE["object_required"], vocab_size=VOCAB)
    top = max(a.n_states, b.n_states)
    async with _sidecar(weights[1], grammar=GrammarConfig(
            max_states=top, arena_states=top + 1)) as (side, channel):
        gen = _unary(channel, "/ggrmcp.tpu.GenerateService/Generate",
                     serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        first = asyncio.ensure_future(gen(serving_pb2.GenerateRequest(
            prompt="a", max_new_tokens=256,
            constraint=_constraint(SUITE["nested"]))))
        while not side.batcher.arena._entries:
            await asyncio.sleep(0.001)
        with pytest.raises(grpc.aio.AioRpcError) as err:
            await gen(serving_pb2.GenerateRequest(
                prompt="b", max_new_tokens=8,
                constraint=_constraint(SUITE["object_required"])))
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert (await first).finish_reason in ("grammar_complete", "stop")


# ---------------------------------------------------------------------------
# Gateway
# ---------------------------------------------------------------------------


async def test_structured_output_tool_call_matches_reference():
    """A tools/call whose output is constrained to a tool's output schema
    (`constraint.toolOutputSchemaRef`, resolved by the unchanged
    reference gateway into an inline schema) returns the same tokenIds
    through the port's sidecar as through the JAX sidecar."""
    import aiohttp

    from ggrmcp_tpu.core import config as cfgmod
    from ggrmcp_tpu.gateway.app import Gateway

    batching = dict(max_batch_size=4, kv_cache_max_seq=512)
    jside = JSidecar(
        JServing(mesh=MeshConfig(tensor=1), batching=JBatching(**batching)),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
    )
    tside = Sidecar(
        ServingConfig(batching=BatchingConfig(**batching)), device="cpu",
        params=params_from_numpy(
            jax.tree.map(np.asarray, jside.generation.params), CPU))
    tool = "ggrmcp_tpu_generateservice_generate"
    source = "ggrmcp_tpu_modelinfoservice_getmodelinfo"
    payloads = []
    for side in (jside, tside):
        port = await side.start(0)
        cfg = cfgmod.default()
        cfg.server.host = "127.0.0.1"
        cfg.server.port = 0
        cfg.grpc.reconnect.enabled = False
        gw = Gateway(cfg, targets=[f"localhost:{port}"])
        await gw.start()
        try:
            async with aiohttp.ClientSession(
                    base_url=f"http://127.0.0.1:{gw.port}") as client:
                resp = await client.post("/", json={
                    "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                    "params": {"name": tool, "arguments": {
                        "prompt": "go", "maxNewTokens": 96,
                        "returnTokens": True,
                        "constraint": {"toolOutputSchemaRef": source},
                    }},
                })
                data = await resp.json()
        finally:
            await gw.stop()
            await side.stop()
        assert "error" not in data, data
        payloads.append(json.loads(data["result"]["content"][0]["text"]))
    ref, out = payloads
    assert out["tokenIds"] == ref["tokenIds"] and out["tokenIds"]
    assert out["finishReason"] == ref["finishReason"]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_config_file_nests_grammar(tmp_path):
    from ggrmcp_tpu_torch import __main__ as cli

    path = tmp_path / "grammar.json"
    path.write_text(json.dumps({"serving": {"model": "tiny-llama", "grammar": {
        "jump_max": 4, "arena_states": 2048}}}))
    cfg = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", str(path)]))
    assert cfg.grammar == GrammarConfig(jump_max=4, arena_states=2048)
    path.write_text(json.dumps({"serving": {"grammar": {"jumpmax": 4}}}))
    with pytest.raises(ValueError, match="jumpmax"):
        cli.serving_config(cli.build_parser().parse_args(
            ["sidecar", "--config", str(path)]))


@pytest.mark.parametrize("kw,field", [
    (dict(max_states=1), "max_states"),
    (dict(max_states=64, arena_states=64), "arena_states"),
    (dict(cache_entries=0), "cache_entries"),
    (dict(jump_max=17), "jump_max"),
    (dict(jump_max=-1), "jump_max"),
])
def test_grammar_config_checks_as_reference(kw, field):
    with pytest.raises(ValueError, match=field):
        GrammarConfig(**kw)
