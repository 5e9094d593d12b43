"""The port's MCP gateway against the JAX package's, over one sidecar of
the port (tiny-llama on the CPU): the same JSON-RPC sequence goes to
both — `initialize`, `tools/list`, a greedy `tools/call`, a call that
fails validation, an unknown tool, `GetModelInfo` — and the answers are
equal up to session ids and timings, `tools/list` byte for byte; then
the names of the `/metrics` families and the shape of `/debug/ticks`.
Both HTTP implementations (the fast lane and aiohttp) run, by the
reference's autouse `http_impl` fixture. Then the reference's own
`test_gateway_http` and `test_middleware_chain` cases run against the
port's gateway (tests/torch_ref_cases.py)."""

import asyncio
import contextlib
import json

import aiohttp

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu.gateway.app import Gateway as JGateway
from ggrmcp_tpu_torch.core import config as tcfg
from ggrmcp_tpu_torch.gateway.app import Gateway as TGateway
from tests import torch_ref_cases
from tests import torch_threads  # noqa: F401

GENERATE = "ggrmcp_tpu_generateservice_generate"
INFO = "ggrmcp_tpu_modelinfoservice_getmodelinfo"
SEQUENCE = [
    ("initialize", {"capabilities": {}}),
    ("tools/list", None),
    ("tools/call", {"name": GENERATE, "arguments": {
        "prompt": "the gateway plane", "maxNewTokens": 6,
        "sampling": {"temperature": 0}}}),
    ("tools/call", {"name": GENERATE, "arguments": {
        "prompt": "x", "temperature": 0.5}}),  # not a Generate field
    ("tools/call", {"name": "no_such_tool", "arguments": {}}),
    ("tools/call", {"name": INFO, "arguments": {}}),
]
# Measured per call, so never equal between two calls.
TIMINGS = ("computeMs",)


def _config(cfgmod, impl: str):
    cfg = cfgmod.default()
    cfg.server.host = "127.0.0.1"
    cfg.server.port = 0
    cfg.server.http_impl = impl
    cfg.grpc.connect_timeout_s = 5.0
    cfg.grpc.reconnect.enabled = False
    return cfg


@contextlib.asynccontextmanager
async def _both_gateways(impl: str):
    """A port sidecar and the two gateways over it: yields (target,
    JAX gateway's client, port gateway's client)."""
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    side = Sidecar(tcfg.ServingConfig(batching=tcfg.BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256)), device="cpu")
    await side.start(0)
    gws = [JGateway(_config(jcfg, impl), targets=[side.target]),
           TGateway(_config(tcfg, impl), targets=[side.target])]
    clients = []
    try:
        for gw in gws:
            await gw.start()
            clients.append(aiohttp.ClientSession(
                base_url=f"http://127.0.0.1:{gw.port}"))
        yield side.target, clients[0], clients[1]
    finally:
        for client in clients:
            await client.close()
        for gw in gws:
            await gw.stop()
        await side.stop()


async def _send(client, i: int, method: str, params) -> tuple[int, bytes]:
    body = {"jsonrpc": "2.0", "method": method, "id": i}
    if params is not None:
        body["params"] = params
    resp = await client.post("/", json=body)
    return resp.status, await resp.read()


def _untimed(body: bytes) -> dict:
    """A JSON-RPC answer without its timings, the tool result's text
    (the backend's answer as JSON) parsed."""
    doc = json.loads(body)
    for item in doc.get("result", {}).get("content", []):
        answer = json.loads(item["text"])
        item["text"] = {k: v for k, v in answer.items() if k not in TIMINGS}
    return doc


def _metric_names(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _shape(obj):
    """The keys of a JSON document, all the way down (lists by their
    first element)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


async def test_port_gateway_answers_as_the_reference():
    impl = torch_port_test_gateway_http._DEFAULT_IMPL  # noqa: F821
    async with _both_gateways(impl) as (_target, ref, port):
        for i, (method, params) in enumerate(SEQUENCE):
            want = await _send(ref, i, method, params)
            got = await _send(port, i, method, params)
            assert got[0] == want[0], (method, got, want)
            if method == "tools/list":
                assert got[1] == want[1]
                assert len(json.loads(got[1])["result"]["tools"]) == 8
                continue
            assert _untimed(got[1]) == _untimed(want[1]), method
        call = _untimed((await _send(port, 9, *SEQUENCE[2]))[1])
        text = call["result"]["content"][0]["text"]
        assert text["completionTokens"] == 6, text
        # Both gateways poll the sidecar's stats in the background: wait
        # for each one's first poll, then the families must agree.
        names = []
        for client in (ref, port):
            for _ in range(100):
                body = await (await client.get("/metrics")).text()
                if "gateway_backend_ttft_ms_bucket" in body:
                    break
                await asyncio.sleep(0.1)
            names.append(_metric_names(body))
        assert names[1] == names[0]
        assert "gateway_backend_ttft_ms" in names[1]
        ticks = []
        for client in (ref, port):
            resp = await client.get("/debug/ticks")
            assert resp.status == 200
            ticks.append(_shape(await resp.json()))
        assert ticks[1] == ticks[0]


torch_port_test_gateway_http = torch_ref_cases.port_module(
    "test_gateway_http")
for _name in ("test_gateway_http", "test_middleware_chain"):
    torch_ref_cases.collect(torch_ref_cases.port_module(_name), globals())
