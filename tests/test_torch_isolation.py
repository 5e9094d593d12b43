"""The PyTorch port stands alone: importing every module of
`ggrmcp_tpu_torch`, and then `chip_smoke` (whose work runs only under
its `__main__` guard), loads neither JAX nor any module of the JAX
package `ggrmcp_tpu`, nor `safetensors`, `tokenizers`, `transformers`
or `ml_dtypes` (`tokenizers` is imported only when a tokenizer file is
loaded; bf16 pages decode through torch, serving/tensors.py). The
port's gateway plane loads no torch either. Its CLI runs with
`ggrmcp_tpu` unimportable: the co-launch with a replica fleet and the
plain gateway answer MCP calls. Checked in fresh interpreters, since
this test process itself has JAX loaded."""

import ast
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, json, pkgutil, sys
import ggrmcp_tpu_torch
names = sorted(
    m.name for m in pkgutil.walk_packages(
        ggrmcp_tpu_torch.__path__, "ggrmcp_tpu_torch."
    )
)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in (
        "jax", "jaxlib", "ggrmcp_tpu", "safetensors", "tokenizers",
        "transformers", "ml_dtypes",
    )
)
print(json.dumps({"modules": names, "bad": bad}))
"""

# Modules each slice of the port added; all must be walked and imported.
PORT_MODULES = (
    "ggrmcp_tpu_torch.grammar", "ggrmcp_tpu_torch.grammar.compiler",
    "ggrmcp_tpu_torch.grammar.runtime",
    "ggrmcp_tpu_torch.models.bert", "ggrmcp_tpu_torch.models.llama",
    "ggrmcp_tpu_torch.ops.attention", "ggrmcp_tpu_torch.ops.quant",
    "ggrmcp_tpu_torch.serving.engine", "ggrmcp_tpu_torch.serving.pages",
    "ggrmcp_tpu_torch.serving.safetensors_io",
    "ggrmcp_tpu_torch.serving.sidecar", "ggrmcp_tpu_torch.serving.tensors",
    "ggrmcp_tpu_torch.serving.tokenizer", "ggrmcp_tpu_torch.serving.weights",
    "ggrmcp_tpu_torch.serving.flight_recorder",
    "ggrmcp_tpu_torch.serving.memory_ledger",
    "ggrmcp_tpu_torch.serving.scheduler", "ggrmcp_tpu_torch.serving.slo",
    "ggrmcp_tpu_torch.serving.batching", "ggrmcp_tpu_torch.utils.failpoints",
    "ggrmcp_tpu_torch.utils.tracing", "ggrmcp_tpu_torch.rpc.server_utils",
    "ggrmcp_tpu_torch.serving.host_pool",
    "ggrmcp_tpu_torch.serving.adapter_arena", "ggrmcp_tpu_torch.ops.lora",
    "ggrmcp_tpu_torch.ops.speculative", "ggrmcp_tpu_torch.ops.sampling",
    "ggrmcp_tpu_torch.serving.spec_batcher",
    "ggrmcp_tpu_torch.serving.tiered", "ggrmcp_tpu_torch.models.moe",
    "ggrmcp_tpu_torch.parallel", "ggrmcp_tpu_torch.parallel.mesh",
    "ggrmcp_tpu_torch.parallel.collectives",
    "ggrmcp_tpu_torch.serving.launcher", "ggrmcp_tpu_torch.ops.ring_attention",
    "ggrmcp_tpu_torch.parallel.pipeline",
    "ggrmcp_tpu_torch.models.training", "ggrmcp_tpu_torch.models.trainer",
    "ggrmcp_tpu_torch.serving.checkpoint",
    "ggrmcp_tpu_torch.serving.compile_watcher",
    "ggrmcp_tpu_torch.serving.fleet", "ggrmcp_tpu_torch.parallel.distributed",
    # The gateway plane.
    "ggrmcp_tpu_torch.core.types", "ggrmcp_tpu_torch.core.headers",
    "ggrmcp_tpu_torch.core.sessions", "ggrmcp_tpu_torch.mcp",
    "ggrmcp_tpu_torch.mcp.types", "ggrmcp_tpu_torch.mcp.validation",
    "ggrmcp_tpu_torch.schema", "ggrmcp_tpu_torch.schema.builder",
    "ggrmcp_tpu_torch.rpc.connection", "ggrmcp_tpu_torch.rpc.descriptors",
    "ggrmcp_tpu_torch.rpc.reflection_client",
    "ggrmcp_tpu_torch.rpc.discovery", "ggrmcp_tpu_torch.rpc.router",
    "ggrmcp_tpu_torch.serving.timeline", "ggrmcp_tpu_torch.gateway",
    "ggrmcp_tpu_torch.gateway.metrics", "ggrmcp_tpu_torch.gateway.middleware",
    "ggrmcp_tpu_torch.gateway.handler", "ggrmcp_tpu_torch.gateway.fastlane",
    "ggrmcp_tpu_torch.gateway.app", "ggrmcp_tpu_torch.utils.jsonlog",
    "ggrmcp_tpu_torch.utils.aio_compat", "ggrmcp_tpu_torch.utils.stats",
    "ggrmcp_tpu_torch.rpc.pb.hello_pb2", "ggrmcp_tpu_torch.rpc.pb.complex_pb2",
)


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(PORT_MODULES) <= set(result["modules"]), result["modules"]
    assert len(result["modules"]) >= 40, result  # every module was walked
    assert result["bad"] == [], f"the port loaded {result['bad']}"


def test_port_sources_name_no_jax_import():
    """No source line of the port or of chip_smoke.py imports JAX, the
    JAX package, `safetensors`, `transformers` or `ml_dtypes`, even
    behind a branch the import check cannot reach."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ggrmcp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offending = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for n, line in enumerate(fh, 1):
                words = line.split()
                if len(words) >= 2 and words[0] in ("import", "from") and (
                    words[1].split(".")[0] in (
                        "jax", "jaxlib", "ggrmcp_tpu", "safetensors",
                        "transformers", "ml_dtypes",
                    )
                ):
                    offending.append(f"{path}:{n}: {line.strip()}")
    assert not offending, offending
    assert any(p.endswith("safetensors_io.py") for p in paths)


def test_moe_family_imports_alone_without_jax():
    """The MoE family module and the registry that resolves it, imported
    alone in a fresh interpreter, load no JAX and no module of the JAX
    package."""
    code = (
        "import json, sys\n"
        "from ggrmcp_tpu_torch.models import family_module, get_model, moe\n"
        "assert family_module(get_model('mixtral-8x7b')[1]) is moe\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'ggrmcp_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# A string of code that names the JAX package as a module: `-m
# ggrmcp_tpu` or a dotted `ggrmcp_tpu.` path (`ggrmcp_tpu_torch` is not).
_REF_MODULE = re.compile(r"(?<![\w.])ggrmcp_tpu\.|-m ggrmcp_tpu\b")


def _docstrings(tree) -> set:
    """The ids of the string constants that are docstrings or other
    bare string statements."""
    return {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)}


def test_port_code_runs_no_module_of_the_jax_package():
    """No string in the code of the port or of chip_smoke.py (docstrings
    and comments aside) names a module of `ggrmcp_tpu`: nothing runs
    `python -m ggrmcp_tpu ...` or imports a module by a dotted name."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ggrmcp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offending = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and _REF_MODULE.search(node.value)):
                offending.append(f"{path}:{node.lineno}: {node.value!r}")
    assert not offending, offending


def test_gateway_plane_loads_no_torch():
    """The plain gateway's import chain (the app and the CLI that runs
    it without --tpu) loads neither torch nor JAX nor the JAX
    package."""
    code = (
        "import json, sys\n"
        "import ggrmcp_tpu_torch.gateway.app, ggrmcp_tpu_torch.__main__\n"
        "import ggrmcp_tpu_torch.serving.fleet\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'jax', 'jaxlib', "
        "'ggrmcp_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# Runs the port's CLI with the JAX package unimportable; at exit it
# prints which of torch / JAX it loaded.
_CLI_STUB = (
    "import atexit, json, sys\n"
    "sys.modules['ggrmcp_tpu'] = None\n"
    "atexit.register(lambda: print(json.dumps(sorted(\n"
    "    m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))),"
    " flush=True))\n"
    "from ggrmcp_tpu_torch.__main__ import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)
GENERATE = "ggrmcp_tpu_generateservice_generate"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _cmdline(pid: int) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        return [a.decode() for a in fh.read().split(b"\0") if a]


def _children(pid: int) -> list:
    out = set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{tid}/children") as fh:
            out.update(int(p) for p in fh.read().split())
    return sorted(out)


def _run_cli(argv: list, until, timeout: float = 120.0):
    """The CLI stub with `argv` until `until(proc)` returns a value (the
    answer), then SIGTERM: (answer, exit code, loaded modules, what was
    still running after the exit)."""
    out = tempfile.TemporaryFile()
    err = tempfile.TemporaryFile()  # files: an undrained pipe wedges
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", _CLI_STUB, *argv],
                            cwd=REPO, env=env, stdout=out, stderr=err)
    try:
        deadline = time.monotonic() + timeout
        while True:
            try:
                answer = until(proc)
            except OSError:
                answer = None
            if answer is not None:
                break
            if proc.poll() is not None or time.monotonic() > deadline:
                err.seek(0)
                raise AssertionError(err.read().decode()[-4000:])
            time.sleep(0.3)
        spawned = _children(proc.pid)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    out.seek(0)
    loaded = json.loads(out.read().decode().strip().splitlines()[-1])
    time.sleep(0.5)
    left = [pid for pid in spawned if os.path.exists(f"/proc/{pid}")]
    return answer, code, loaded, left


def test_colaunch_with_a_fleet_serves_without_the_jax_package(tmp_path):
    """`gateway --tpu` with `fleet.enabled` (one worker) on the CPU, with
    `ggrmcp_tpu` unimportable: the fleet's worker serves, its command is
    the port's worker, an MCP `tools/call` is answered, and SIGTERM
    leaves no worker."""
    port = _free_port()
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({
        "serving": {"batching": {"max_batch_size": 4,
                                 "kv_cache_max_seq": 256}},
        "fleet": {"enabled": True, "min_replicas": 1, "max_replicas": 1,
                  "decide_interval_s": 0.3}}))

    def served(proc):
        st = _post(port, "/admin/fleet?action=status", {})["fleet"]
        if not any(r["state"] == "serving" for r in st["replicas"]):
            return None
        workers = [_cmdline(pid) for pid in _children(proc.pid)]
        calls = [_post(port, "/", {
            "jsonrpc": "2.0", "method": "tools/call", "id": i, "params": {
                "name": GENERATE, "arguments": {
                    "prompt": "no jax", "maxNewTokens": 3}}})
            for i in range(2)]
        return workers, calls

    (workers, calls), code, loaded, left = _run_cli(
        ["gateway", "--tpu", "--model", "tiny-llama", "--device", "cpu",
         "--http-port", str(port), "--config", str(path)], served)
    assert [w[1:] for w in workers] == [
        ["-m", "ggrmcp_tpu_torch.serving.fleet"]], workers
    for call in calls:
        assert "result" in call and not call["result"].get("isError"), call
    assert code == 0 and left == []
    assert "torch" in loaded and "jax" not in loaded


async def test_plain_gateway_fronts_a_backend_without_torch():
    """`gateway --backend unix:SOCK` (no --tpu) before a gRPC backend,
    with `ggrmcp_tpu` unimportable in the gateway: it answers a
    `tools/call` and never loads torch."""
    import asyncio

    from tests.backend_utils import InProcessBackend

    sock = os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-plain-{os.getpid()}.sock")
    port = _free_port()

    def called(_proc):
        return _post(port, "/", {
            "jsonrpc": "2.0", "method": "tools/call", "id": 1, "params": {
                "name": "hello_helloservice_sayhello",
                "arguments": {"name": "plain"}}})

    async with InProcessBackend(uds=sock) as backend:
        answer, code, loaded, _ = await asyncio.to_thread(
            _run_cli, ["gateway", "--backend", backend.target,
                       "--http-port", str(port)], called)
    assert "plain" in answer["result"]["content"][0]["text"], answer
    assert code == 0 and loaded == []


async def test_plain_gateway_workers_share_the_port():
    """`gateway --backend ... --workers 2`: two gateway processes of the
    port on one port (SO_REUSEPORT) under a parent that loads no torch;
    a `tools/call` is answered and SIGTERM ends the group with exit 0."""
    import asyncio

    from tests.backend_utils import InProcessBackend

    sock = os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-workers-{os.getpid()}.sock")
    port = _free_port()

    def called(proc):
        if len(_children(proc.pid)) < 2:
            return None
        return _post(port, "/", {
            "jsonrpc": "2.0", "method": "tools/call", "id": 1, "params": {
                "name": "hello_helloservice_sayhello",
                "arguments": {"name": "workers"}}}), _children(proc.pid)

    async with InProcessBackend(uds=sock) as backend:
        (answer, workers), code, loaded, left = await asyncio.to_thread(
            _run_cli, ["gateway", "--backend", backend.target,
                       "--workers", "2", "--http-port", str(port)], called)
    assert "workers" in answer["result"]["content"][0]["text"], answer
    assert len(workers) >= 2 and code == 0 and loaded == []
    assert left == []


# Loads the port's hello backend with the JAX package unimportable,
# prints which of torch / JAX / the JAX package it loaded, then serves
# on a free port (it prints TARGET=...).
_HELLO_STUB = (
    "import asyncio, importlib.util, json, sys\n"
    "sys.modules['ggrmcp_tpu'] = None\n"
    "spec = importlib.util.spec_from_file_location(\n"
    "    'hello_server_torch', 'examples/hello_server_torch.py')\n"
    "hello = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(hello)\n"
    "print(json.dumps(sorted(m for m, mod in sys.modules.items()\n"
    "    if mod is not None\n"
    "    and m.split('.')[0] in ('torch', 'jax', 'ggrmcp_tpu'))),"
    " flush=True)\n"
    "asyncio.run(hello.serve(0))\n"
)


def test_port_hello_backend_behind_the_plain_gateway():
    """The quick start on the port alone: `examples/hello_server_torch.py`
    and the plain gateway before it, both with `ggrmcp_tpu`
    unimportable. tools/list names SayHello and a tools/call answers
    "Hello, X!"; neither process loads torch or JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = tempfile.TemporaryFile()
    backend = subprocess.Popen([sys.executable, "-c", _HELLO_STUB], cwd=REPO,
                               env=env, stdout=out, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        lines = []
        while not any(ln.startswith("TARGET=") for ln in lines):
            assert backend.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
            out.seek(0)
            lines = out.read().decode().splitlines()
        backend_loaded = json.loads(lines[0])
        target = lines[1].split("=", 1)[1]
        port = _free_port()

        def answered(_proc):
            tools = _post(port, "/", {"jsonrpc": "2.0", "method": "tools/list",
                                      "id": 1})["result"]["tools"]
            if not tools:
                return None
            return tools, _post(port, "/", {
                "jsonrpc": "2.0", "method": "tools/call", "id": 2, "params": {
                    "name": "hello_helloservice_sayhello",
                    "arguments": {"name": "port"}}})

        (tools, call), code, loaded, _ = _run_cli(
            ["gateway", "--backend", target, "--http-port", str(port)],
            answered)
    finally:
        backend.terminate()
        backend.wait(timeout=30)
    assert backend_loaded == []
    assert "hello_helloservice_sayhello" in [t["name"] for t in tools]
    assert json.loads(call["result"]["content"][0]["text"]) == {
        "message": "Hello, port!"}, call
    assert code == 0 and loaded == []
