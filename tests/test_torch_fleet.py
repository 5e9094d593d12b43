"""The replica fleet of the port (ggrmcp_tpu_torch/serving/fleet.py: the
supervisor and the worker) against the reference's worker
(ggrmcp_tpu/serving/fleet.py, tests/test_fleet.py), on the CPU:

- `worker_serving_config` gives the settings the reference's
  `_worker_main` builds from the same GGRMCP_FLEET_WORKER_* knobs, field
  by field, paged on and off;
- a standalone worker (`--device cpu` by the handshake) prints TARGET=
  and answers GetModelInfo; a worker serving a port checkpoint of the
  JAX package's tiny-llama params answers a greedy Generate with the JAX
  engine's tokens on those params (exact);
- a co-launch with `fleet.enabled`: the port's gateway, in this
  process, spawns the port's worker, lists it in /admin/fleet and its
  metrics, the replica's greedy tokens equal the co-launched sidecar's
  (one seed), a SIGKILLed worker is restarted by the port's supervisor
  and serves again, and `stop()` leaves no worker alive;
- the port's supervisor over the port's worker armed with
  `replica_crash`: the worker exits 86 and is healed.
"""

import asyncio
import json
import os
import signal
import socket
import sys
import time
import urllib.request

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.parallel import mesh as jmesh_mod
from ggrmcp_tpu.serving import fleet as jfleet
from ggrmcp_tpu_torch.core import config as tcfg
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.core.config import config_from_dict
from ggrmcp_tpu_torch.rpc.discovery import ServiceDiscoverer
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import checkpoint, fleet, launcher
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = [sys.executable, "-m", "ggrmcp_tpu_torch.serving.fleet"]
GENERATE = "ggrmcp_tpu_generateservice_generate"
SMALL = {"max_batch_size": 4, "kv_cache_max_seq": 256, "prefill_chunk": 16}
PROMPTS = ("fleet parity", "x" * 30)
NEW = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _children(ppid: int) -> dict[int, list[str]]:
    """Live children of `ppid`: pid -> command line."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = [a.decode() for a in fh.read().split(b"\0") if a]
        except OSError:
            continue
        if int(stat[1]) == ppid and stat[0] != "Z":
            out[int(name)] = cmd
    return out


def _http(port: int, path: str, body=None) -> dict | str:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        raw = resp.read()
    return json.loads(raw) if path != "/metrics" else raw.decode()


def _fleet_status(port: int) -> dict:
    return _http(port, "/admin/fleet?action=status", {})["fleet"]


def _mcp_tokens(port: int, prompt: str) -> list[int]:
    data = _http(port, "/", {
        "jsonrpc": "2.0", "method": "tools/call", "id": 1, "params": {
            "name": GENERATE, "arguments": {
                "prompt": prompt, "maxNewTokens": NEW,
                "returnTokens": True}}})
    assert "result" in data and not data["result"].get("isError"), data
    return json.loads(data["result"]["content"][0]["text"])["tokenIds"]


async def _generate(target: str, prompt: str) -> list[int]:
    async with grpc.aio.insecure_channel(target) as ch:
        gen = ch.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateResponse.FromString)
        resp = await gen(serving_pb2.GenerateRequest(
            prompt=prompt, max_new_tokens=NEW, return_tokens=True),
            timeout=120)
    return list(resp.token_ids)


async def _until(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        got = await asyncio.to_thread(pred)
        if got:
            return got
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.2)


# -- the worker's settings ----------------------------------------------------


def _reference_worker_serving(env: dict, monkeypatch) -> JServing:
    """The ServingConfig the reference's `_worker_main` builds from
    `env` (its Sidecar replaced by a recorder that stops the worker)."""
    from ggrmcp_tpu.serving import sidecar as jsidecar

    seen = []

    class Stop(Exception):
        pass

    class Recorder:
        def __init__(self, serving):
            seen.append(serving)
            raise Stop

    monkeypatch.setattr(jsidecar, "Sidecar", Recorder)
    monkeypatch.setattr(os, "environ", dict(env))
    with pytest.raises(Stop):
        asyncio.run(jfleet._worker_main())
    return seen[0]


@pytest.mark.parametrize("env", [
    {},
    {"GGRMCP_FLEET_WORKER_PAGED": "on"},
    {"GGRMCP_FLEET_WORKER_PAGED": "on", "GGRMCP_FLEET_WORKER_PAGES": "64",
     "GGRMCP_FLEET_WORKER_SLOTS": "2"},
    {"GGRMCP_FLEET_WORKER_MODEL": "tiny-mistral",
     "GGRMCP_FLEET_WORKER_ROLE": "decode",
     "GGRMCP_FLEET_WORKER_PAGED": "on",
     "GGRMCP_FLEET_WORKER_MAXSEQ": "1024",
     "GGRMCP_FLEET_WORKER_PENDING": "3"},
], ids=["defaults", "paged", "paged-pages-slots", "model-role-seq-pending"])
def test_worker_serving_config_matches_reference(env, monkeypatch):
    ref = _reference_worker_serving(env, monkeypatch)
    got = fleet.worker_serving_config(env)
    for key in ("model", "role"):
        assert getattr(got, key) == getattr(ref, key), key
    for key in ("max_batch_size", "kv_cache_max_seq",
                "decode_steps_per_tick", "max_pending", "paged_kv",
                "paged_kv_pages"):
        assert (getattr(got.batching, key)
                == getattr(ref.batching, key)), key


def test_handshake_goes_over_the_knobs():
    serving = ServingConfig(model="tiny-mistral", uds_path="/tmp/x.sock",
                            port=5555,
                            batching=BatchingConfig(max_batch_size=3))
    env = {**fleet.handshake_environ(serving, "cpu", 7),
           "GGRMCP_FLEET_WORKER_MODEL": "tiny-llama",
           "GGRMCP_FLEET_WORKER_SLOTS": "4"}
    got = fleet.worker_serving_config(env)
    assert got.model == "tiny-mistral"
    assert got.batching.max_batch_size == 3
    assert (got.uds_path, got.port) == ("", 0)
    assert env[fleet.ENV_DEVICE] == "cpu" and env[fleet.ENV_SEED] == "7"


# -- standalone workers -------------------------------------------------------


async def _spawn_worker(env: dict):
    proc = await asyncio.create_subprocess_exec(
        *WORKER, env={**os.environ, **env}, cwd=REPO,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 120)
    except BaseException:
        proc.kill()
        await proc.wait()
        raise
    text = line.decode().strip()
    if not text.startswith("TARGET="):
        proc.kill()
        await proc.wait()
        raise AssertionError(f"bad handshake {text!r}")
    return proc, text.removeprefix("TARGET=")


async def test_standalone_worker_prints_target_and_answers_model_info():
    proc, target = await _spawn_worker({fleet.ENV_DEVICE: "cpu"})
    try:
        assert target.startswith("localhost:")
        async with grpc.aio.insecure_channel(target) as ch:
            info = await ch.unary_unary(
                "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                request_serializer=serving_pb2.ModelInfoRequest
                .SerializeToString,
                response_deserializer=serving_pb2.ModelInfoResponse
                .FromString)(serving_pb2.ModelInfoRequest(), timeout=60)
        assert info.model_id == "tiny-llama"
        assert proc.returncode is None
    finally:
        proc.kill()
        await proc.wait()


async def test_worker_without_a_card_exits_nonzero():
    """No device in the handshake: the worker asks for the card, and on a
    machine without one it exits non-zero before any TARGET= line; it
    never serves on the CPU instead."""
    env = {k: v for k, v in os.environ.items() if k != fleet.ENV_DEVICE}
    proc = await asyncio.create_subprocess_exec(
        *WORKER, env=env, cwd=REPO, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.DEVNULL)
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), 120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    assert proc.returncode != 0 and b"TARGET=" not in out


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX package's tiny-llama params and the greedy tokens its own
    sidecar (engine and batcher) answers for PROMPTS on them."""
    from ggrmcp_tpu.core.config import BatchingConfig as JBatching
    from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar

    async def run():
        side = JSidecar(
            JServing(mesh=JMesh(tensor=1), batching=JBatching(**SMALL)),
            mesh=jmesh_mod.build_mesh(JMesh(tensor=1), jax.devices()[:1]))
        port = await side.start(0)
        try:
            want = [await _generate(f"localhost:{port}", p)
                    for p in PROMPTS]
        finally:
            await side.stop()
        return jax.tree.map(np.asarray, side.generation.params), want

    return asyncio.run(run())


async def test_worker_serves_a_checkpoint_of_jax_params(jax_tiny, tmp_path):
    params, want = jax_tiny
    tree = params_from_numpy(params, torch.device("cpu"))
    path = str(tmp_path / "params")
    checkpoint.save(path, checkpoint.flatten(tree), kind="params",
                    model="tiny-llama", step=0, dtype="float32")
    serving = ServingConfig(checkpoint_path=path,
                            batching=BatchingConfig(**SMALL))
    proc, target = await _spawn_worker(
        fleet.handshake_environ(serving, "cpu", 0))
    try:
        got = [await _generate(target, p) for p in PROMPTS]
    finally:
        proc.kill()
        await proc.wait()
    assert got == want and all(got)


# -- the fleet behind the co-launch ------------------------------------------


async def _fleet_scenario() -> dict:
    """One co-launch with the fleet on (one replica): what the gateway
    spawned, /admin/fleet and /metrics, tokens of the replica, of the
    sidecar and through MCP, a SIGKILLed worker's heal, and what is left
    after stop()."""
    port = _free_port()
    cfg = config_from_dict({
        "serving": {"model": "tiny-llama", "batching": SMALL},
        "fleet": {"enabled": True, "min_replicas": 1, "max_replicas": 1,
                  "decide_interval_s": 0.3, "backoff_base_s": 0.2,
                  "backoff_max_s": 1.0, "backoff_jitter": 0.0,
                  "max_actions_per_window": 10, "action_window_s": 5.0},
        "server": {"host": "127.0.0.1", "port": port,
                   "rate_limit": {"enabled": False}},
    })
    co = launcher.Colaunch(cfg, device="cpu", seed=0)
    out: dict = {}
    await co.start()
    try:
        def serving():
            try:
                st = _fleet_status(port)
            except OSError:
                return None
            reps = [r for r in st["replicas"] if r["state"] == "serving"]
            return st if reps else None

        status = await _until(serving, 120, "no replica ever served")
        out["status"] = status
        out["workers"] = _children(os.getpid())
        target = status["replicas"][0]["target"]
        out["replica"] = [await _generate(target, p) for p in PROMPTS]
        out["sidecar"] = [await _generate(co.target, p) for p in PROMPTS]
        out["mcp"] = [await asyncio.to_thread(_mcp_tokens, port, p)
                      for p in PROMPTS]
        out["metrics"] = await asyncio.to_thread(_http, port, "/metrics")

        (victim,) = out["workers"]
        os.kill(victim, signal.SIGKILL)

        def healed():
            st = _fleet_status(port)
            reps = [r for r in st["replicas"] if r["state"] == "serving"]
            return st if st["counters"]["restarts"] >= 1 and reps else None

        healed_status = await _until(healed, 120, "never healed")
        out["healed_status"] = healed_status
        out["healed_workers"] = _children(os.getpid())
        new = healed_status["replicas"][0]["target"]
        out["healed"] = [await _generate(new, p) for p in PROMPTS]
        out["gateway_alive"] = co.gateway is not None
    finally:
        pids = set(_children(os.getpid())) | set(out.get("workers", {}))
        await co.stop()
    out["left"] = [pid for pid in pids if _alive(pid)]
    return out


@pytest.fixture(scope="module")
def scenario():
    return asyncio.run(_fleet_scenario())


def test_gateway_spawns_the_ports_worker(scenario):
    (cmd,) = scenario["workers"].values()
    assert cmd[1:] == ["-m", "ggrmcp_tpu_torch.serving.fleet"], cmd
    assert not any("ggrmcp_tpu.serving.fleet" in a for a in cmd)


def test_admin_fleet_and_metrics_list_the_worker(scenario):
    status = scenario["status"]
    assert status["counters"]["spawns"] == 1
    assert status["actions"][0]["kind"] == "spawn"
    assert status["replicas"][0]["target"].startswith("localhost:")
    assert "gateway_fleet_replicas" in scenario["metrics"]


def test_replica_tokens_equal_the_sidecars(scenario):
    assert scenario["replica"] == scenario["sidecar"]
    assert scenario["mcp"] == scenario["sidecar"]
    assert all(len(t) == NEW for t in scenario["replica"])


def test_sigkilled_worker_is_restarted_and_serves(scenario):
    status = scenario["healed_status"]
    kinds = [a["kind"] for a in status["actions"]]
    assert "restart" in kinds
    assert any("process exited" in a["reason"] for a in status["actions"])
    assert set(scenario["healed_workers"]).isdisjoint(scenario["workers"])
    assert scenario["healed"] == scenario["sidecar"]
    assert scenario["gateway_alive"]


def test_stop_leaves_no_worker(scenario):
    assert scenario["left"] == []


async def test_replica_crash_exits_86_and_is_healed():
    """The reference's drill (tests/test_fleet.py) over the port's
    supervisor and worker: armed with replica_crash:every=3, the worker
    aborts on its third call with exit code 86; the supervisor restarts
    it and the replacement serves with a fresh count."""
    cfg = tcfg.default()
    cfg.grpc.reconnect.enabled = False
    cfg.grpc.call_timeout_s = 60.0
    disc = ServiceDiscoverer([], cfg.grpc)
    env = {**os.environ, fleet.ENV_DEVICE: "cpu",
           "GGRMCP_FAILPOINTS": "replica_crash:every=3",
           fleet.ENV_SERVING: json.dumps({"batching": SMALL})}
    adapter = fleet.GatewayFleetAdapter(disc, fleet.ProcessReplicaFactory(
        env=env, cwd=REPO, ready_timeout_s=120.0))
    sup = fleet.FleetSupervisor(
        tcfg.FleetConfig(min_replicas=1, max_replicas=1,
                         backoff_base_s=0.1, backoff_max_s=0.5,
                         backoff_jitter=0.0, max_actions_per_window=10,
                         action_window_s=5.0),
        adapter)
    try:
        await disc.discover_services()
        await sup.run_once()
        (target,) = list(adapter.procs)
        doomed = adapter.procs[target]
        outcomes = []
        for i in range(3):
            try:
                out = await disc.invoke_by_tool(GENERATE, {
                    "prompt": f"crash {i}", "maxNewTokens": 4,
                    "returnTokens": True})
                outcomes.append(out["tokenIds"])
            except Exception as exc:  # noqa: BLE001 — typed below
                outcomes.append(exc)
        assert all(isinstance(o, list) and o for o in outcomes[:2]), outcomes
        assert isinstance(outcomes[2], Exception), outcomes
        assert await doomed.wait() == 86
        deadline = time.monotonic() + 60.0
        restarted = False
        while time.monotonic() < deadline and not restarted:
            restarted = any(a.kind == "restart" for a in await sup.run_once())
            await asyncio.sleep(0.1)
        assert restarted
        for i in range(2):
            out = await disc.invoke_by_tool(GENERATE, {
                "prompt": f"healed {i}", "maxNewTokens": 4,
                "returnTokens": True})
            assert out["tokenIds"]
    finally:
        await adapter.close()
        await disc.close()
