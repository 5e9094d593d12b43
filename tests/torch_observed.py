"""A gateway of the port over a sidecar of the port, for the
reference's endpoint cases that need a real sidecar behind the gateway
(tests/test_torch_gateway_timeline.py): the counterpart of
`tests/test_observability.py::observed_env` on the CPU, tiny-llama with
4 slots of 256 positions unless the case gives other serving fields."""

import contextlib

import aiohttp

from ggrmcp_tpu_torch.core import config as cfgmod
from ggrmcp_tpu_torch.gateway.app import Gateway
from tests.test_observability import _generate_call  # noqa: F401


def gateway_config(impl: str) -> cfgmod.Config:
    cfg = cfgmod.default()
    cfg.server.host = "127.0.0.1"
    cfg.server.port = 0
    cfg.server.http_impl = impl
    cfg.grpc.connect_timeout_s = 5.0
    cfg.grpc.reconnect.enabled = False
    return cfg


@contextlib.asynccontextmanager
async def observed_env(impl: str, **serving_kw):
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    serving_kw.setdefault("batching", cfgmod.BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256))
    side = Sidecar(cfgmod.ServingConfig(**serving_kw), device="cpu")
    await side.start(0)
    gw = Gateway(gateway_config(impl), targets=[side.target])
    await gw.start()
    client = aiohttp.ClientSession(base_url=f"http://127.0.0.1:{gw.port}")
    try:
        yield side, gw, client
    finally:
        await client.close()
        await gw.stop()
        await side.stop()
