"""`python -m ggrmcp_tpu_torch gateway --tpu` end to end (the counterpart
of tests/test_colaunch.py): as a subprocess on the CPU it answers MCP
`initialize`, `tools/list` and a Generate `tools/call` through the
port's gateway and sidecar in that one process, over
`{tempdir}/ggrmcp-sidecar-{pid}.sock`, starts no child process, and
exits 0 on SIGTERM with the socket removed. Parity: the greedy
`tokenIds` of a `tools/call` through the port's co-launch equal those
through the reference's `launcher._run`, whose sidecar holds the same
weights (the JAX init crossed through `params_from_numpy`): exact
equality."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import jax
import numpy as np
import torch

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving import launcher as jlauncher
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch.core.config import BatchingConfig, Config, ServingConfig
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.serving import launcher
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATE = "ggrmcp_tpu_generateservice_generate"
SMALL = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, method: str, params=None, rid: int = 1) -> dict:
    body = {"jsonrpc": "2.0", "method": method, "id": rid}
    if params is not None:
        body["params"] = params
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _generate(port: int, prompt: str) -> list[int]:
    data = _post(port, "tools/call", {
        "name": GENERATE,
        "arguments": {"prompt": prompt, "maxNewTokens": 6,
                      "returnTokens": True}})
    assert "result" in data and not data["result"].get("isError"), data
    return json.loads(data["result"]["content"][0]["text"])["tokenIds"]


def _children(pid: int) -> list[int]:
    """The child processes of `pid` (Linux)."""
    out = set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{tid}/children") as fh:
            out.update(int(p) for p in fh.read().split())
    return sorted(out)


def test_cli_colaunch_serves_mcp_over_uds_and_exits_clean():
    port = _free_port()
    errfile = tempfile.TemporaryFile()  # a file: an undrained pipe wedges
    proc = subprocess.Popen(
        [sys.executable, "-m", "ggrmcp_tpu_torch", "gateway", "--tpu",
         "--model", "tiny-llama", "--device", "cpu", "--http-port",
         str(port)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=errfile)
    sock = os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-sidecar-{proc.pid}.sock")
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                init = _post(port, "initialize", {})
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    errfile.seek(0)
                    raise AssertionError(errfile.read().decode()[-3000:])
                time.sleep(0.5)
        assert "result" in init, init
        tools = {t["name"] for t in _post(port, "tools/list")["result"]["tools"]}
        assert GENERATE in tools
        assert len(_generate(port, "hello co-launch")) == 6
        assert os.path.exists(sock)
        assert _children(proc.pid) == []
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    errfile.seek(0)
    assert code == 0, errfile.read().decode()[-3000:]
    assert not os.path.exists(sock)


async def test_colaunch_tokens_match_reference_colaunch():
    prompts = ("parity through both gateways", "x" * 30)
    jside = JSidecar(
        jcfg.ServingConfig(
            mesh=MeshConfig(tensor=1), batching=JBatching(**SMALL),
            uds_path=os.path.join(tempfile.gettempdir(),
                                  f"ggrmcp-tcl-ref-{os.getpid()}.sock")),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
    )
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jside.generation.params),
        torch.device("cpu"))

    ref_cfg = jcfg.default()
    ref_cfg.server.host = "127.0.0.1"
    ref_cfg.server.port = _free_port()
    ref_cfg.grpc.reconnect.enabled = False
    task = asyncio.create_task(jlauncher._run(ref_cfg, [], lambda: jside))
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                ref = [await asyncio.to_thread(_generate, ref_cfg.server.port,
                                               p) for p in prompts]
                break
            except OSError:
                assert time.monotonic() < deadline and not task.done()
                await asyncio.sleep(0.3)
    finally:
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    cfg = Config(serving=ServingConfig(batching=BatchingConfig(**SMALL)))
    cfg.server.host = "127.0.0.1"
    cfg.server.port = port = _free_port()
    launcher.resolve_colaunch_transport(cfg)
    co = launcher.Colaunch(
        cfg, sidecar_factory=lambda: Sidecar(cfg.serving, params=tparams,
                                             device="cpu"))
    await co.start()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                got = [await asyncio.to_thread(_generate, port, p)
                       for p in prompts]
                break
            except OSError:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.3)
        assert co.target == f"unix:{cfg.serving.uds_path}"
    finally:
        await co.stop()
    assert got == ref and all(got)
