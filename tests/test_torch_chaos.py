"""Failpoints in the port against the JAX package's hook sites: the same
tiny-llama weights, float32, greedy.

- `tick_fail:every=3` and `admit_fail:times=1` on the fused, chunked,
  paged and interleaved routes: a poison request's admission fails
  ("error"), then every request of the route's sequence ends with the
  tokens of the unfailed run and of the JAX batcher, with as many
  replays as the JAX batcher makes.
- The open fault of an admission that dies writing the shared paged
  arena while an interleaved prefill is in flight: the port does what
  the reference does (finish reasons, replays, the tokens of the rows
  not stranded).
- `page_exhausted` answers RESOURCE_EXHAUSTED; `grammar_jump_fail`
  degrades typed as in the JAX batcher; `health_flap` alternates the
  health probe as the reference's hook does; `replica_crash` ends the
  sidecar's process, and the unchanged gateway's watchdog re-admits the
  sidecar restarted on the same target.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys

import aiohttp
import grpc
import pytest

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.grammar import compile_schema as j_compile
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.rpc import server_utils as j_server_utils
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc import server_utils
from ggrmcp_tpu_torch.rpc.pb import health_pb2, serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import failpoints
from tests.test_grammar_jump import SCHEMAS
from tests.test_torch_observability import VOCAB, engines  # noqa: F401
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = [5, 6, 7]
LONG = [3 + (i * 7 % 500) for i in range(100)]
BASE = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=32,
            max_queue_delay_ms=1000.0, tick_retry_limit=32)
PAGED = dict(paged_kv="on", paged_kv_page_size=16)
ILV = dict(prefill_interleave="on", prefill_interleave_rows=2)
BURST = [[5, 6, 7], [9, 8, 7, 6, 5], [11, 12], [13, 3, 14, 15, 9, 26]]
ROUTES = {
    "fused": (BASE, BURST),
    "chunked": (BASE, BURST[:2] + [LONG, LONG[::-1][:70]]),
    "paged": (dict(BASE, **PAGED), BURST[:3] + [LONG]),
    "interleaved": (dict(BASE, **ILV), None),
}


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    jfail.registry.disarm()
    yield
    failpoints.registry.disarm()
    jfail.registry.disarm()


def _arm(spec: str) -> None:
    failpoints.registry.arm_spec(spec)
    jfail.registry.arm_spec(spec)


async def _drain(batcher, prompt, max_new, reference, seed=0, started=None,
                 grammar=None):
    greedy = JSampling() if reference else SamplingConfig()
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, greedy,
                                            seed=seed, grammar=grammar):
        if started is not None:
            started.set()
        out.extend(ids)
    return out, reason


async def _route(batcher, route, reference, poison: bool):
    """The route's sequence on a started batcher, after a poison request
    (whose admission the armed admit_fail fails) when `poison`."""
    batcher.start()
    try:
        if poison:
            assert await _drain(batcher, [4, 2], 4, reference) == (
                [], "error")
        prompts = ROUTES[route][1]
        if prompts is not None:
            return await asyncio.gather(*(
                _drain(batcher, p, 12, reference, seed=i)
                for i, p in enumerate(prompts)))
        # Interleaved: a long prompt lands while a short one decodes.
        started = asyncio.Event()
        short = asyncio.create_task(_drain(batcher, SHORT, 24, reference,
                                           started=started))
        await started.wait()
        long_out = await _drain(batcher, LONG, 8, reference, seed=1)
        return [await short, long_out]
    finally:
        await batcher.stop()


@pytest.mark.parametrize("route", sorted(ROUTES))
async def test_failpoints_replay_matches_unfailed_and_reference(
        engines, route):  # noqa: F811
    jeng, teng = engines
    cfg = ROUTES[route][0]
    clean = await _route(ContinuousBatcher(teng, BatchingConfig(**cfg)),
                         route, False, poison=False)
    _arm("tick_fail:every=3,admit_fail:times=1")
    jb = JBatcher(jeng, JBatching(**cfg))
    ref = await _route(jb, route, True, poison=True)
    jfail.registry.disarm()
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out = await _route(tb, route, False, poison=True)
    assert out == clean == ref
    assert all(r in ("length", "stop") for _, r in out)
    replayed = tb.stats()["replayed_requests"]
    assert replayed == jb.replayed > 0
    assert tb.stats()["replay_exhausted"] == 0
    if route == "interleaved":
        assert tb.interleaved_chunks >= 1
    _, recs = tb.flight_snapshot()
    assert sorted(r.finish_reason for r in recs).count("error") == 1


async def test_admission_dying_on_shared_arena_strands_interleaved_rows(
        engines):  # noqa: F811
    """The inherited fault, reached without a failpoint (admit_fail fires
    before any call writes the shared cache): the admission of a second
    short request raises inside the call that writes the paged arena
    while a long prompt's interleaved prefill is in flight. The arena is
    rebuilt and the decoding row replays, but the interleaved row runs
    on and finishes over the rebuilt arena. The port does what the
    reference does."""
    jeng, teng = engines
    cfg = dict(BASE, **PAGED, **ILV)
    long = [3 + (i * 11 % 490) for i in range(200)]  # 7 chunks

    async def scenario(batcher, reference, fail: bool):
        if fail:
            name = "_admit_single" if reference else "_admit_single_impl"
            real = getattr(batcher, name)
            calls = []

            def dying(*args, **kwargs):
                calls.append(1)
                if len(calls) == 2:  # the second short's admission
                    raise RuntimeError("injected: shared arena write died")
                return real(*args, **kwargs)

            setattr(batcher, name, dying)
        batcher.start()
        try:
            started = asyncio.Event()
            short = asyncio.create_task(_drain(batcher, SHORT, 40, reference,
                                               started=started))
            await started.wait()
            long_task = asyncio.create_task(_drain(batcher, long, 6,
                                                   reference, seed=1))
            # The loop yields after every tick: the second request is
            # queued right after the interleave's first chunk.
            while batcher.interleaved_chunks < 1:
                await asyncio.sleep(0)
            second = await _drain(batcher, [9, 9, 9], 6, reference, seed=2)
            return [await short, await long_task, second]
        finally:
            await batcher.stop()

    clean = await scenario(ContinuousBatcher(teng, BatchingConfig(**cfg)),
                           False, fail=False)
    jb = JBatcher(jeng, JBatching(**cfg))
    ref = await scenario(jb, True, fail=True)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out = await scenario(tb, False, fail=True)
    assert [r for _, r in out] == [r for _, r in ref]
    assert out[2] == ref[2] == ([], "error")
    # The decoding row replayed onto the rebuilt arena: its tokens are
    # the unfailed run's. The interleaved row is the stranded one: its
    # first token comes from its own prefill, the rest read an arena
    # that never received its prompt's K/V.
    assert out[0] == ref[0] == clean[0]
    assert out[1][0][0] == clean[1][0][0] and out[1] != clean[1]
    assert tb.stats()["replayed_requests"] == jb.replayed == 1
    assert tb.interleaved_admissions == 1


async def test_page_exhausted_answers_resource_exhausted():
    side = Sidecar(ServingConfig(
        batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=64,
                                **PAGED),
        failpoints="page_exhausted:times=1"), device="cpu")
    port = await side.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            gen = ch.unary_unary(
                "/ggrmcp.tpu.GenerateService/Generate",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateResponse
                .FromString)
            req = serving_pb2.GenerateRequest(prompt="pages", max_new_tokens=3)
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await gen(req, metadata=(("x-qos-class", "batch"),))
            assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            assert "retry in 2s" in err.value.details()
            resp = await gen(req)
            assert resp.finish_reason in ("length", "stop")
        stats = side.batcher.stats()
        assert stats["shed_requests"] == 1
        assert {c["name"]: c["unevaluated"] for c in stats["slo_classes"]}[
            "batch"] == 1
    finally:
        await side.stop()


async def test_grammar_jump_fail_degrades_as_reference(engines):  # noqa: F811
    jeng, teng = engines
    rows = [([3, 1, 4, 1], SCHEMAS["const_obj"], 256),
            ([2, 7, 1], SCHEMAS["enum_obj"], 256), ([6, 6], None, 12)]
    cfg = dict(max_batch_size=4, kv_cache_max_seq=512, tick_retry_limit=8,
               max_queue_delay_ms=1000.0)

    async def run(batcher, reference):
        compile_fn = j_compile if reference else compile_schema
        batcher.start()
        try:
            return await asyncio.gather(*(
                _drain(batcher, p, n, reference, seed=i, grammar=None
                       if s is None else compile_fn(s, vocab_size=VOCAB))
                for i, (p, s, n) in enumerate(rows)))
        finally:
            await batcher.stop()

    clean = await run(ContinuousBatcher(teng, BatchingConfig(**cfg)), False)
    _arm("grammar_jump_fail:every=2,times=2")
    jb = JBatcher(jeng, JBatching(**cfg))
    ref = await run(jb, True)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out = await run(tb, False)
    assert out == ref == clean
    fallbacks = tb.stats()["grammar_jump_fallbacks"]
    assert fallbacks == jb.counter_stats()["grammar_jump_fallbacks"] == 2


class _Ctx:
    async def abort(self, code, details):
        raise AssertionError(f"aborted {code}: {details}")


async def test_health_flap_alternates_as_reference():
    """Armed every=2, the probe answers NOT_SERVING on every second call,
    in the port's health service as in the reference's."""
    _arm("health_flap:every=2")
    req = health_pb2.HealthCheckRequest()
    got = [(await server_utils.HealthService().check(req, _Ctx())).status
           for _ in range(4)]
    ref = [(await j_server_utils.HealthService().check(req, _Ctx())).status
           for _ in range(4)]
    serving, down = (health_pb2.HealthCheckResponse.SERVING,
                     health_pb2.HealthCheckResponse.NOT_SERVING)
    assert got == ref == [serving, down, serving, down]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(port: int, failpoint_spec: str = ""):
    env = {k: v for k, v in os.environ.items()
           if k not in ("GGRMCP_FAILPOINTS", "PYTHONPATH")}
    if failpoint_spec:
        env["GGRMCP_FAILPOINTS"] = failpoint_spec
    return subprocess.Popen(
        [sys.executable, "-m", "ggrmcp_tpu_torch", "sidecar", "--model",
         "tiny-llama", "--device", "cpu", "--port", str(port),
         "--log-level", "warning"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


async def _serving(port: int, proc, timeout: float = 120.0) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
        check = ch.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest
            .SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString)
        while True:
            assert proc.poll() is None, "the sidecar exited while starting"
            try:
                await check(health_pb2.HealthCheckRequest(), timeout=1.0)
                return
            except grpc.aio.AioRpcError:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.2)


async def _tool_call(client, id_):
    resp = await client.post("/", json={
        "jsonrpc": "2.0", "method": "tools/call", "id": id_,
        "params": {"name": "ggrmcp_tpu_generateservice_generate",
                   "arguments": {"prompt": "still there?",
                                 "maxNewTokens": 2}},
    })
    return await resp.json()


async def test_replica_crash_then_gateway_readmits_the_restart():
    """replica_crash:every=2 ends the sidecar's process (exit 86) on its
    second Generate; the sidecar restarted on the same target is
    re-admitted by the gateway's watchdog with no gateway restart, as
    tests/test_recovery.py holds for the hello backend."""
    from ggrmcp_tpu.core import config as cfgmod
    from ggrmcp_tpu.gateway.app import Gateway

    port = _free_port()
    proc = _spawn(port, "replica_crash:every=2")
    restarted = gw = None
    try:
        await _serving(port, proc)
        cfg = cfgmod.default()
        cfg.server.host = "127.0.0.1"
        cfg.server.port = 0
        cfg.grpc.reconnect.enabled = True
        cfg.grpc.reconnect.watchdog_interval_s = 0.3
        cfg.grpc.reconnect.interval_s = 0.1
        cfg.grpc.reconnect.max_attempts = 2
        cfg.grpc.connect_timeout_s = 2.0
        gw = Gateway(cfg, targets=[f"localhost:{port}"])
        await gw.start()
        async with aiohttp.ClientSession(
                base_url=f"http://127.0.0.1:{gw.port}") as client:
            first = await _tool_call(client, 1)
            assert "error" not in first and not first["result"].get(
                "isError"), first
            crashed = await _tool_call(client, 2)
            assert crashed["result"]["isError"] is True
            assert await asyncio.get_running_loop().run_in_executor(
                None, proc.wait, 60) == 86
            restarted = _spawn(port)
            await _serving(port, restarted)
            deadline = asyncio.get_running_loop().time() + 60.0
            while True:
                data = await _tool_call(client, 3)
                if "result" in data and not data["result"].get("isError"):
                    break
                assert asyncio.get_running_loop().time() < deadline, data
                await asyncio.sleep(0.3)
            payload = json.loads(data["result"]["content"][0]["text"])
            assert payload["finishReason"] in ("length", "stop")
            assert (await client.get("/health")).status == 200
    finally:
        if gw is not None:
            await gw.stop()
        for p in (proc, restarted):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(30)
