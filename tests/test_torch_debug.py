"""DebugService of the port's sidecar over gRPC on the CPU, the memory
ledger, and the unchanged gateway's /debug routes in front of a port
sidecar.

- GetFlightRecord with and without trace-id and tenant filters.
- GetMemory: the components sum to total_bytes; with reconcile,
  attributed + unattributed == live; `weights` is the engine's weight
  bytes and `kv_arena` the shared cache's.
- Profile writes a parseable Chrome trace under the sanitised label
  (`../x` stays under the base directory); a second concurrent capture
  is FAILED_PRECONDITION.
- The ledger counts a storage once however many views reach it, and a
  storage two components claim once (counted as double registered).
"""

import asyncio
import contextlib
import json
import os
import tempfile

import aiohttp
import grpc
import pytest
import torch

from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.memory_ledger import MemoryLedger
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import tracing
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
BASE = os.path.join(tempfile.gettempdir(), "ggrmcp-profiles")


def _stub(ch, method, req, resp):
    return ch.unary_unary(method, request_serializer=req.SerializeToString,
                          response_deserializer=resp.FromString)


@contextlib.asynccontextmanager
async def debug_env(**serving):
    side = Sidecar(ServingConfig(**serving), device="cpu")
    port = await side.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            yield side, port, dict(
                generate=_stub(ch, "/ggrmcp.tpu.GenerateService/Generate",
                               serving_pb2.GenerateRequest,
                               serving_pb2.GenerateResponse),
                flight=_stub(ch, "/ggrmcp.tpu.DebugService/GetFlightRecord",
                             serving_pb2.FlightRecordRequest,
                             serving_pb2.FlightRecordResponse),
                memory=_stub(ch, "/ggrmcp.tpu.DebugService/GetMemory",
                             serving_pb2.MemoryRequest,
                             serving_pb2.MemoryResponse),
                profile=_stub(ch, "/ggrmcp.tpu.DebugService/Profile",
                              serving_pb2.ProfileRequest,
                              serving_pb2.ProfileResponse),
            )
    finally:
        await side.stop()


GEN = dict(batching=BatchingConfig(max_batch_size=4, kv_cache_max_seq=128))


async def test_flight_record_filters():
    async with debug_env(**GEN) as (_, _, rpc):
        calls = [("t-1", "acme"), ("t-2", "globex"), ("t-3", "acme")]
        await asyncio.gather(*(
            rpc["generate"](serving_pb2.GenerateRequest(
                prompt=f"request {i}", max_new_tokens=3),
                metadata=(("x-trace-id", tid), ("x-tenant-id", tenant)))
            for i, (tid, tenant) in enumerate(calls)))
        everything = await rpc["flight"](serving_pb2.FlightRecordRequest())
        assert everything.enabled
        assert sorted(r.trace_id for r in everything.requests) == [
            "t-1", "t-2", "t-3"]
        assert everything.ticks and not everything.compiles
        for t in everything.ticks:
            phases = (t.phase_admit_ms + t.phase_sync_ms
                      + t.phase_dispatch_ms + t.phase_wait_ms
                      + t.phase_host_ms)
            assert abs(phases - t.duration_ms) < 1e-6
        one = await rpc["flight"](serving_pb2.FlightRecordRequest(
            trace_id="t-2"))
        assert [r.trace_id for r in one.requests] == ["t-2"]
        assert one.ticks and all("t-2" in t.trace_ids for t in one.ticks)
        acme = await rpc["flight"](serving_pb2.FlightRecordRequest(
            tenant="acme"))
        assert sorted(r.trace_id for r in acme.requests) == ["t-1", "t-3"]
        assert len(acme.ticks) == len(everything.ticks)  # ticks unfiltered
        last = await rpc["flight"](serving_pb2.FlightRecordRequest(
            max_ticks=1, max_requests=1))
        assert len(last.ticks) == len(last.requests) == 1


async def test_memory_components_and_reconcile():
    async with debug_env(**GEN) as (side, _, rpc):
        await rpc["generate"](serving_pb2.GenerateRequest(
            prompt="fill", max_new_tokens=2))
        plain = await rpc["memory"](serving_pb2.MemoryRequest())
        assert plain.enabled
        comp = {c.component: c.bytes for c in plain.components}
        assert sum(comp.values()) == plain.total_bytes
        assert comp["weights"] == side.generation.weight_bytes()
        assert comp["kv_arena"] == side.batcher.cache.nbytes()
        assert {"grammar_arena", "prefix_pool", "ilv_mini",
                "tick_state"} <= set(comp)
        assert plain.live_bytes == 0  # no reconcile asked
        rec = await rpc["memory"](serving_pb2.MemoryRequest(reconcile=True))
        attributed = sum(c.bytes for c in rec.components)
        assert attributed == rec.total_bytes
        assert attributed + rec.unattributed_bytes == rec.live_bytes
        assert rec.live_bytes >= attributed > 0
        assert not rec.host and rec.compile_count == 0
        stats = side.batcher.stats()
        assert stats["memory_weights_bytes"] == comp["weights"]
        assert stats["memory_kv_arena_bytes"] == comp["kv_arena"]


async def test_memory_of_an_embed_sidecar():
    async with debug_env(model="bert-tiny") as (side, _, rpc):
        rec = await rpc["memory"](serving_pb2.MemoryRequest(reconcile=True))
        comp = {c.component: c.bytes for c in rec.components}
        assert comp == {"weights": side.embedding.weight_bytes()}
        assert comp["weights"] + rec.unattributed_bytes == rec.live_bytes


async def test_profile_writes_a_trace_under_the_sanitised_label():
    async with debug_env(**GEN) as (_, _, rpc):
        resp = await rpc["profile"](serving_pb2.ProfileRequest(
            duration_ms=50, output_dir="../x"))
        assert os.path.dirname(resp.output_path) == os.path.join(BASE, "x")
        assert resp.duration_ms == 50
        with open(resp.output_path) as fh:
            trace = json.load(fh)
        assert "traceEvents" in trace
        # One capture at a time.
        calls = [rpc["profile"](serving_pb2.ProfileRequest(
            duration_ms=400, output_dir=f"busy-{i}")) for i in range(2)]
        results = await asyncio.gather(*calls, return_exceptions=True)
        codes = sorted(str(r.code()) if isinstance(r, grpc.aio.AioRpcError)
                       else "ok" for r in results)
        assert codes == ["StatusCode.FAILED_PRECONDITION", "ok"]


def test_cuda_capture_without_kernels_raises(monkeypatch):
    """A capture that asked for CUDA and holds no kernel event is an
    error, never a CPU-only trace passed off as a device one."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    real = torch.profiler.profile
    # The CPU build records no device activity: ask for it, get none.
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: real(
        activities=[a for a in activities if a != cuda]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with tempfile.TemporaryDirectory() as out:
        with pytest.raises(RuntimeError, match="no kernel event"):
            tracing.profile_capture(10, out, cuda=True)
        path = tracing.profile_capture(10, out, cuda=False)
        with open(path) as fh:
            assert tracing.kernel_events(json.load(fh)) == []


async def test_gateway_debug_routes_in_front_of_the_port():
    from ggrmcp_tpu.gateway.app import Gateway
    from tests.test_gateway_http import gateway_config

    async with debug_env(**GEN) as (_, port, _):
        gw = Gateway(gateway_config("aiohttp"), targets=[f"localhost:{port}"])
        await gw.start()
        try:
            async with aiohttp.ClientSession(
                    base_url=f"http://127.0.0.1:{gw.port}") as client:
                resp = await client.post("/", json={
                    "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                    "params": {
                        "name": "ggrmcp_tpu_generateservice_generate",
                        "arguments": {"prompt": "debug me",
                                      "maxNewTokens": 3}},
                }, headers={"X-Trace-Id": "trace-debug"})
                assert "error" not in await resp.json()
                bodies = {}
                for route in ("/debug/ticks", "/debug/requests",
                              "/debug/timeline", "/debug/memory",
                              "/debug/slo"):
                    resp = await client.get(route)
                    assert resp.status == 200, route
                    bodies[route] = await resp.json()
                resp = await client.post("/debug/profile?duration_ms=20")
                assert resp.status == 200
        finally:
            await gw.stop()
    [backend] = bodies["/debug/requests"]["backends"]
    assert [r["traceId"] for r in backend["requests"]] == ["trace-debug"]
    assert bodies["/debug/ticks"]["backends"][0]["ticks"]
    [mem] = bodies["/debug/memory"]["backends"]
    assert int(mem["liveBytes"]) == int(mem["totalBytes"]) + int(
        mem.get("unattributedBytes", 0))


def test_ledger_counts_storages_once():
    base = torch.zeros(1000)
    other = torch.ones(10, dtype=torch.float64)
    ledger = MemoryLedger(CPU)
    ledger.register("a", lambda: (base, base[:10], base.view(10, 100)))
    ledger.register("b", lambda: {"x": other, "alias": base})
    ledger.register("empty", lambda: None)
    assert ledger.component_bytes() == {("", "a"): 4000, ("", "b"): 4080,
                                        ("", "empty"): 0}
    rec = ledger.reconcile()
    assert rec["double_registered"] == 1
    assert rec["components"] == {"a": 4000, "b": 80, "empty": 0}
    assert rec["attributed_bytes"] == 4080
    assert rec["attributed_bytes"] + rec["unattributed_bytes"] == (
        rec["live_bytes"])
    off = MemoryLedger(CPU, enabled=False)
    off.register("a", lambda: base)
    assert off.component_bytes() == {} and off.reconcile()["components"] == {}


@pytest.mark.parametrize("where", ["none", "first", "straddling"])
def test_capture_check_scans_the_trace_in_chunks(tmp_path, where):
    """The capture's kernel check reads the trace in 4 MiB chunks (no
    whole-file parse holding the GIL) and finds a kernel event whose
    text straddles two chunks."""
    head, event = b'{"traceEvents": [', b'{"ph": "X", "cat": "kernel"}'
    body = bytearray(b" " * ((1 << 22) + 4096))
    at = {"none": None, "first": 100,
          # `"cat": "kernel"` from 5 bytes before the first chunk's end
          "straddling": (1 << 22) - 5 - len(head) - event.index(b'"cat"')}
    if at[where] is not None:
        body[at[where]:at[where] + len(event)] = event
    text = head + bytes(body) + b"]}"
    if where == "straddling":
        assert text.index(b'"cat"') == (1 << 22) - 5
    path = tmp_path / "trace.json"
    path.write_bytes(text)
    assert tracing._holds_kernel(str(path)) == (where != "none")
