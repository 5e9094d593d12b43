"""The port's co-launch supervisor (serving/launcher.py) against the
reference's (`ggrmcp_tpu/serving/launcher.py`, tests/test_fleet.py's
launcher tests): the transport rule agrees with the reference function
on the four cases of tests/test_distributed.py; the gateway and the
sidecar serve from this process, with no child; a sidecar death is
restarted on the same socket with the fleet's backoff and the
discoverer nudged, so a `tools/call` through the same gateway succeeds
again long before its discovery watchdog would have run (and with a
watchdog reconnecting every few milliseconds, which pauses until the
nudge); an exhausted
budget raises `SidecarSupervisionError` and the gateway stops; a clean
stop leaves no socket file and no child. The sidecar here is a fake
(the hello backend of tests/backend_utils.py on a unix socket) behind
the port's gateway."""

import asyncio
import json
import os
import socket
import tempfile
import time
import urllib.request

import pytest

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu.serving import launcher as jlauncher
from ggrmcp_tpu_torch.core.config import Config, FleetConfig, ServingConfig
from ggrmcp_tpu_torch.serving import launcher
from tests.backend_utils import InProcessBackend
from tests import torch_threads  # noqa: F401

HELLO_TOOL = "hello_helloservice_sayhello"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["default", "pinned_port", "explicit_uds",
                                  "uds_off"])
def test_transport_rule_matches_reference(case):
    port_cfg, ref_cfg = Config(), jcfg.default()
    change = {
        "default": {},
        "pinned_port": {"port": 59999},
        "explicit_uds": {"uds_path": "/tmp/mine.sock"},
        "uds_off": {"colaunch_uds": False},
    }[case]
    port_cfg.serving = ServingConfig(**change)
    for k, v in change.items():
        setattr(ref_cfg.serving, k, v)
    launcher.resolve_colaunch_transport(port_cfg)
    jlauncher.resolve_colaunch_transport(ref_cfg)
    assert port_cfg.serving.uds_path == ref_cfg.serving.uds_path
    if case == "default":
        assert os.path.basename(port_cfg.serving.uds_path) == (
            f"ggrmcp-sidecar-{os.getpid()}.sock")


class FakeSidecar:
    """The launcher's sidecar surface (start / stop / target / server)
    over the hello backend, on a fixed unix socket so that a restart
    reclaims the same target."""

    def __init__(self, path: str, fail: bool = False):
        self.path, self.fail = path, fail
        self.backend = None
        self.target = ""
        self.stopped = False

    @property
    def server(self):
        return self.backend.server

    async def start(self, port=None) -> int:
        if self.fail:
            raise RuntimeError("replacement refused to start")
        self.backend = InProcessBackend(uds=self.path)
        await self.backend.__aenter__()
        self.target = self.backend.target
        return 0

    async def stop(self) -> None:
        self.stopped = True
        if self.backend is not None:
            await self.backend.__aexit__()


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


async def _call_ok(port: int) -> bool:
    try:
        data = await asyncio.to_thread(_post, port, {
            "jsonrpc": "2.0", "method": "tools/call", "id": 1,
            "params": {"name": HELLO_TOOL, "arguments": {"name": "sup"}}})
    except OSError:
        return False
    return "result" in data and not data["result"].get("isError", False)


async def _until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if await pred():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(what)


def _children() -> list[int]:
    """This process's child processes (Linux)."""
    pid = os.getpid()
    with open(f"/proc/{pid}/task/{pid}/children") as fh:
        return [int(p) for p in fh.read().split()]


def _colaunch(made: list, path: str, attempts: int = 4, fail_after: int = 0):
    def factory():
        sidecar = FakeSidecar(path, fail=bool(fail_after)
                              and len(made) >= fail_after)
        made.append(sidecar)
        return sidecar

    cfg = Config(
        fleet=FleetConfig(backoff_base_s=0.05, backoff_max_s=0.2,
                          backoff_jitter=0.0, restart_max_attempts=attempts))
    # A discovery watchdog far longer than any wait here: the restarted
    # sidecar is found by the supervisor's nudge, not by the watchdog.
    cfg.grpc.reconnect.watchdog_interval_s = 600.0
    cfg.server.host = "127.0.0.1"
    cfg.server.port = port = _free_port()
    return launcher.Colaunch(cfg, sidecar_factory=factory), port


def _sock(name: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-tl-{name}-{os.getpid()}.sock")


async def test_sidecar_death_is_restarted_and_served_again():
    made: list = []
    path = _sock("restart")
    co, port = _colaunch(made, path)
    await co.start()
    try:
        await _until(lambda: _call_ok(port), 30, "gateway never ready")
        await made[0].backend.server.stop(None)  # the sidecar dies
        await _until(lambda: _restarted(co), 30, "the sidecar never restarted")
        # Nudged: the first call after the restart succeeds.
        assert await _call_ok(port)
        assert co.restarts == 1 and len(made) == 2
        assert made[0].stopped and co.sidecar is made[1]
        assert co.target == f"unix:{path}"
    finally:
        await co.stop()
    assert not os.path.exists(path) and not _children()


async def _restarted(co) -> bool:
    return co.restarts > 0


async def test_restart_with_a_busy_watchdog_is_served_again():
    """Deaths while the discoverer's watchdog reconnects the backend every
    few milliseconds: the watchdog pauses from the death to the nudge,
    so its reconnect cannot close the channel under the nudge's
    reflection call (which then waited forever: the restart never
    finished, the card's phase 16 twice). Each death is restarted and
    served again."""
    made: list = []
    co, port = _colaunch(made, _sock("busywatch"), attempts=5)
    co.cfg.fleet.backoff_base_s = 0.2
    co.cfg.grpc.reconnect.watchdog_interval_s = 0.01
    co.cfg.grpc.reconnect.interval_s = 0.01
    co.cfg.grpc.connect_timeout_s = 0.5
    await co.start()
    discoverer = co.gateway.discoverer
    (backend,) = discoverer.backends
    # Each reconnect the watchdog makes, and whether a death was then
    # not yet restarted.
    deaths, during = [0], []
    connect = backend.connect

    async def spy_connect(*args, **kwargs):
        if asyncio.current_task() is discoverer._watchdog_task:
            during.append(co.restarts < deaths[0])
        return await connect(*args, **kwargs)

    backend.connect = spy_connect
    try:
        await _until(lambda: _call_ok(port), 30, "gateway never ready")
        for death in range(1, 6):
            deaths[0] = death
            await made[-1].backend.server.stop(None)
            await _until(lambda: _restarts(co, death), 30,
                         f"death {death} was never restarted")
            await _until(lambda: _call_ok(port), 30,
                         f"no call served after death {death}")
        assert co.restarts == 5
        assert discoverer._watchdog_task is not None
        assert not any(during), (
            f"{sum(during)} of {len(during)} watchdog reconnects ran "
            f"between a death and its restart")
    finally:
        await co.stop()


async def _restarts(co, n: int) -> bool:
    return co.restarts >= n


async def test_exhausted_budget_raises_typed_and_stops_gateway():
    made: list = []
    co, port = _colaunch(made, _sock("giveup"), attempts=2, fail_after=1)
    stop = asyncio.Event()
    task = asyncio.create_task(launcher.run_colaunch(co, stop))
    await _until(lambda: _call_ok(port), 30, "gateway never ready")
    await made[0].backend.server.stop(None)
    with pytest.raises(launcher.SidecarSupervisionError,
                       match="2 restart attempts failed"):
        await asyncio.wait_for(task, 30)
    assert len(made) == 3  # the original and two failed replacements
    assert co.gateway is None and not await _call_ok(port)


async def test_gateway_and_sidecar_serve_from_this_process():
    """The reference's layout: one event loop, no child process; the
    gateway's discoverer holds the sidecar's target."""
    made: list = []
    co, port = _colaunch(made, _sock("inproc"))
    await co.start()
    try:
        await _until(lambda: _call_ok(port), 30, "gateway never ready")
        assert not _children()
        assert [b.target for b in co.gateway.discoverer.backends] == [
            co.target]
        assert co.port == port
    finally:
        await co.stop()


async def test_clean_stop_leaves_no_socket_and_no_child():
    made: list = []
    path = _sock("stop")
    co, port = _colaunch(made, path)
    stop = asyncio.Event()
    task = asyncio.create_task(launcher.run_colaunch(co, stop))
    deadline = time.monotonic() + 30
    while not await _call_ok(port):
        assert time.monotonic() < deadline and not task.done()
        await asyncio.sleep(0.05)
    assert os.path.exists(path)
    stop.set()
    await asyncio.wait_for(task, 30)  # returns, no error
    assert not os.path.exists(path) and not _children()
    assert co.restarts == 0 and made[0].stopped and co.gateway is None
