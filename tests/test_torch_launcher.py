"""The port's co-launch supervisor (serving/launcher.py) against the
reference's (`ggrmcp_tpu/serving/launcher.py`, tests/test_fleet.py's
launcher tests): the transport rule agrees with the reference function
on the four cases of tests/test_distributed.py; a sidecar death is
restarted on the same socket with the fleet's backoff and a `tools/call`
through the same gateway child succeeds again; an exhausted budget
raises `SidecarSupervisionError` with the child gone; a child gateway
that exits stops the sidecar and raises with its exit code; a clean
stop leaves no socket file and no child. The sidecar here is a fake
(the hello backend of tests/backend_utils.py on a unix socket); the
gateway child is the real, unchanged `python -m ggrmcp_tpu gateway`."""

import asyncio
import json
import os
import signal
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


async def _until(pred, timeout: float, what: str, colaunch) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if await pred():
            return
        assert colaunch.child.returncode is None, colaunch.log_tail()
        await asyncio.sleep(0.2)
    raise AssertionError(f"{what}; gateway log:\n{colaunch.log_tail()}")


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _colaunch(made: list, path: str, attempts: int = 4, fail_after: int = 0):
    def factory():
        sidecar = FakeSidecar(path, fail=bool(fail_after)
                              and len(made) >= fail_after)
        made.append(sidecar)
        return sidecar

    cfg = Config(
        fleet=FleetConfig(backoff_base_s=0.05, backoff_max_s=0.2,
                          backoff_jitter=0.0, restart_max_attempts=attempts),
        # A short discovery watchdog: the child rediscovers the restarted
        # sidecar on its own (the launcher cannot reach its discoverer).
        sections={"grpc": {"reconnect": {"watchdog_interval_s": 0.5}},
                  "server": {"host": "127.0.0.1"}},
    )
    port = _free_port()
    return launcher.Colaunch(cfg, ["--http-port", str(port)],
                             sidecar_factory=factory), port


def _sock(name: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-tl-{name}-{os.getpid()}.sock")


async def test_sidecar_death_is_restarted_and_served_again():
    made: list = []
    path = _sock("restart")
    co, port = _colaunch(made, path)
    await co.start()
    try:
        await _until(lambda: _call_ok(port), 60, "gateway never ready", co)
        await made[0].backend.server.stop(None)  # the sidecar dies
        await _until(lambda: _call_ok(port) if co.restarts else _false(),
                     60, "gateway never recovered the sidecar", co)
        assert co.restarts == 1 and len(made) == 2
        assert made[0].stopped and co.sidecar is made[1]
        assert co.target == f"unix:{path}"
    finally:
        await co.stop()
    assert not os.path.exists(path) and _gone(co.child.pid)


async def _false() -> bool:
    return False


async def test_exhausted_budget_raises_typed_and_ends_child():
    made: list = []
    co, port = _colaunch(made, _sock("giveup"), attempts=2, fail_after=1)
    await co.start()
    try:
        await _until(lambda: _call_ok(port), 60, "gateway never ready", co)
        await made[0].backend.server.stop(None)
        with pytest.raises(launcher.SidecarSupervisionError,
                           match="2 restart attempts failed"):
            await asyncio.wait_for(co.wait(), 30)
    finally:
        await co.stop()
    assert len(made) == 3  # the original and two failed replacements
    assert co.child.returncode is not None and _gone(co.child.pid)


async def test_gateway_exit_stops_sidecar_and_raises():
    made: list = []
    co, port = _colaunch(made, _sock("gwexit"))
    await co.start()
    try:
        await _until(lambda: _call_ok(port), 60, "gateway never ready", co)
        os.killpg(co.child.pid, signal.SIGKILL)
        with pytest.raises(launcher.GatewayExitedError) as err:
            await asyncio.wait_for(co.wait(), 30)
        assert err.value.code == -signal.SIGKILL
    finally:
        await co.stop()
    assert made[0].stopped and len(made) == 1


async def test_clean_stop_leaves_no_socket_and_no_child():
    made: list = []
    path = _sock("stop")
    co, port = _colaunch(made, path)
    stop = asyncio.Event()
    task = asyncio.create_task(launcher.run_colaunch(co, stop))
    deadline = time.monotonic() + 60
    while not await _call_ok(port):
        assert time.monotonic() < deadline and not task.done()
        await asyncio.sleep(0.2)
    assert os.path.exists(path)
    stop.set()
    await asyncio.wait_for(task, 30)  # returns, no error
    assert not os.path.exists(path)
    assert co.child.returncode is not None and _gone(co.child.pid)
    assert co.restarts == 0 and made[0].stopped
