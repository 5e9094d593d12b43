"""The port's gateway plane against the reference's text.

Every module the port copies from `ggrmcp_tpu` for its gateway (core
types, headers and sessions, the MCP types and validation, the schema
builder, the gRPC connection, descriptors, reflection client, discovery
and router, the timeline, the gateway's metrics, middleware, handler,
fast lane and app, the tracer, the JSON log formatter and the asyncio
shim; the supervisor half of `serving/fleet.py`) equals the reference's
text except for the lines listed here: imports that name the port's
package (checked line by line), the listed blocks that point the
gateway's fleet at the port's worker, and three comments that drop the
reference's citation of its own issue and PR numbers. The gateway's config classes
equal the reference's source, and `Config.validate` refuses what the
reference refuses with the same message. Then the reference's own unit
cases for the pure modules (`test_core_types`, `test_headers`,
`test_sessions`, `test_mcp_validation`, `test_schema_builder`,
`test_transcoder`) run against the port's modules
(tests/torch_ref_cases.py).
"""

import dataclasses
import difflib
import inspect
import os
import re

import pytest

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu_torch.core import config as tcfg
from tests import torch_ref_cases
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Module -> the (reference lines, port lines) blocks allowed to differ
# beyond the imports that name the port's package.
ALLOWED = {
    "utils/jsonlog.py": [], "utils/aio_compat.py": [], "core/types.py": [],
    "core/headers.py": [], "core/sessions.py": [], "mcp/__init__.py": [],
    "mcp/types.py": [], "mcp/validation.py": [], "schema/__init__.py": [],
    "schema/builder.py": [], "rpc/connection.py": [],
    "rpc/descriptors.py": [], "rpc/reflection_client.py": [],
    "rpc/discovery.py": [], "rpc/router.py": [], "serving/timeline.py": [],
    "gateway/__init__.py": [], "gateway/metrics.py": [],
    "gateway/middleware.py": [], "gateway/handler.py": [],
    "gateway/fastlane.py": [],
    # The fleet's workers take the port's handshake: their device and
    # seed, through the Gateway and `run`.
    "gateway/app.py": [
        ([], ["        worker_device: Optional[str] = None,",
              "        worker_seed: int = 0,"]),
        ([], ["        # The port's fleet workers serve on this device "
              "(None: the card)",
              "        # with weights from this seed (serving/fleet.py "
              "handshake).",
              "        self.worker_device = worker_device",
              "        self.worker_seed = worker_seed"]),
        ([], ["            handshake_environ,"]),
        (["        env.update({",
          '            "GGRMCP_FLEET_WORKER_MODEL": serving.model,',
          '            "GGRMCP_FLEET_WORKER_ROLE": serving.role,',
          '            "GGRMCP_FLEET_WORKER_SLOTS":',
          "                str(serving.batching.max_batch_size),",
          '            "GGRMCP_FLEET_WORKER_MAXSEQ":',
          "                str(serving.batching.kv_cache_max_seq),",
          '            "GGRMCP_FLEET_WORKER_PAGED": serving.batching.paged_kv,',
          "        })"],
         ["        env.update(handshake_environ(",
          "            serving, self.worker_device, self.worker_seed))"]),
        ([], ["    worker_device: Optional[str] = None,",
              "    worker_seed: int = 0,"]),
        (["    gateway = Gateway(cfg, targets)"],
         ["    gateway = Gateway(cfg, targets, worker_device=worker_device,",
          "                      worker_seed=worker_seed)"]),
    ],
    # The tracer, up to the reference's JAX profile capture (the port's
    # capture on torch.profiler follows it).
    "utils/tracing.py": [([], ["import re"])],
    # The supervisor half, up to the worker: the imports the port's
    # worker takes, and the worker command.
    "serving/fleet.py": [
        (["default `python -m ggrmcp_tpu.serving.fleet`, the sidecar "
          "worker in"],
         ["default `python -m ggrmcp_tpu_torch.serving.fleet`, the "
          "sidecar worker in"]),
        ([], ["import json"]),
        ([], ["import signal"]),
        (["from typing import Any, Callable, Optional"],
         ["from typing import Any, Callable, Mapping, Optional"]),
        (["from ggrmcp_tpu.core.config import FleetConfig",
          "from ggrmcp_tpu.serving.slo import windowed_delta"],
         ["from ggrmcp_tpu_torch.core.config import (",
          "    BatchingConfig,", "    FleetConfig,", "    ServingConfig,",
          "    config_from_dict,", ")",
          "from ggrmcp_tpu_torch.serving.slo import windowed_delta"]),
        (['    return [sys.executable, "-m", "ggrmcp_tpu.serving.fleet"]'],
         ['    return [sys.executable, "-m", '
          '"ggrmcp_tpu_torch.serving.fleet"]']),
    ],
}
# Module -> the port's comment lines that drop the reference's citation
# of its own issue or PR number (the rest of the line may be reworded).
SCRUBBED = {
    "rpc/discovery.py": [
        "        # Adapter'd calls disaggregate too: page chains"],
    "rpc/router.py": [
        "        cumulative admit-phase share of tick time (the recorder's "
        "phase"],
    "serving/fleet.py": [
        "Everything below closes the observe→decide→act loop that earlier "
        "work"],
}
CITATION = re.compile(r"\b(?:ISSUE|PRs?) \d")
# Where the compared text ends: (reference line, port line).
ENDS = {
    "utils/tracing.py": (
        "def profile_capture(duration_ms: float, output_dir: "
        "Optional[str] = None) -> str:",
        "def kernel_events(trace: dict) -> list[dict]:"),
    "serving/fleet.py": (
        "# The replica worker (python -m ggrmcp_tpu.serving.fleet)",
        "# The replica worker (python -m ggrmcp_tpu_torch.serving.fleet)"),
}


def _lines(pkg: str, path: str, end: str = None) -> list[str]:
    with open(os.path.join(REPO, pkg, path), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    return lines[:lines.index(end)] if end else lines


def _is_port_import(old: str, new: str) -> bool:
    return (old.lstrip().startswith(("from ggrmcp_tpu.", "import ggrmcp_tpu."))
            and new == old.replace("ggrmcp_tpu.", "ggrmcp_tpu_torch.", 1))


@pytest.mark.parametrize("path", sorted(ALLOWED))
def test_copy_equals_reference_text(path):
    ref_end, port_end = ENDS.get(path, (None, None))
    ref = _lines("ggrmcp_tpu", path, ref_end)
    port = _lines("ggrmcp_tpu_torch", path, port_end)
    blocks, scrubbed = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        old, new = ref[i1:i2], port[j1:j2]
        if len(old) == len(new) and all(map(_is_port_import, old, new)):
            continue
        if (len(old) == len(new) == 1 and CITATION.search(old[0])
                and not CITATION.search(new[0])):
            scrubbed.append(new[0])
            continue
        blocks.append((old, new))
    assert blocks == ALLOWED[path]
    assert scrubbed == SCRUBBED.get(path, [])


# The reference's gateway config classes, copied source and all.
CONFIG_CLASSES = (
    "SecurityConfig", "CORSConfig", "RateLimitConfig", "ServerConfig",
    "KeepAliveConfig", "ReconnectConfig", "HeaderForwardingConfig",
    "DescriptorSetConfig", "GRPCConfig", "ValidationConfig", "MCPConfig",
    "SessionRateLimitConfig", "SessionConfig", "SchemaCacheConfig",
    "ToolsConfig", "RoutingConfig", "GatewayConfig", "LoggingConfig",
    "MetricsConfig",
)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_gateway_config_class_is_the_reference_source(name):
    """Byte for byte, but for MCPConfig's server version, which the
    port reads from its own package (the same distribution's
    version)."""
    want = inspect.getsource(getattr(jcfg, name)).replace(
        '__import__("ggrmcp_tpu")', '__import__("ggrmcp_tpu_torch")')
    assert inspect.getsource(getattr(tcfg, name)) == want
    assert tcfg.MCPConfig().server_version == jcfg.MCPConfig().server_version


def test_config_tree_has_the_reference_sections_and_fleet_fields():
    assert ([f.name for f in dataclasses.fields(tcfg.Config)]
            == [f.name for f in dataclasses.fields(jcfg.Config)])
    assert (dataclasses.asdict(tcfg.FleetConfig())
            == dataclasses.asdict(jcfg.FleetConfig()))
    assert tcfg.ROUTING_POLICIES == jcfg.ROUTING_POLICIES
    assert (inspect.getsource(tcfg._coerce)
            == inspect.getsource(jcfg._coerce))


# (section, key, value) set on the defaults: each must fail validate()
# in both packages with the same message.
BAD = [
    ("server", "port", 0), ("server", "workers", 0),
    ("server", "http_impl", "uvloop"), ("server", "request_timeout_s", 0),
    ("grpc", "port", 70000), ("grpc", "connect_timeout_s", 0),
    ("grpc", "max_message_bytes", 0), ("session", "max_sessions", 0),
    ("tools", "max_schema_depth", 0), ("gateway", "tools", {"t": {"x": 1}}),
    ("gateway", "structured_output", {"t": 3}),
    ("gateway.routing", "policy", "random"),
    ("gateway.routing", "spill_threshold", -1.0),
    ("gateway.routing", "disagg", "on"),
    ("fleet", "min_replicas", 0), ("fleet", "max_replicas", 0),
    ("fleet", "shed_hold_s", 20.0), ("fleet", "flap_threshold", 1),
    ("fleet", "backoff_jitter", 1.0), ("fleet", "decide_interval_s", 0.0),
    ("fleet", "action_log", 0), ("logging", "format", "xml"),
]


def _set(cfg, section: str, key: str, value) -> None:
    obj = cfg
    for part in section.split("."):
        obj = getattr(obj, part)
    setattr(obj, key, value)


@pytest.mark.parametrize("section,key,value", BAD,
                         ids=[f"{s}.{k}" for s, k, _ in BAD])
def test_validate_refuses_as_the_reference(section, key, value):
    ours, ref = tcfg.default(), jcfg.default()
    _set(ours, section, key, value)
    _set(ref, section, key, value)
    with pytest.raises(ValueError) as want:
        ref.validate()
    with pytest.raises(ValueError) as got:
        ours.validate()
    assert str(got.value) == str(want.value)


def test_file_and_env_load_as_the_reference(tmp_path):
    """A config file of gateway sections and the GGRMCP_* environment
    over it give the reference's values, section by section."""
    path = tmp_path / "gw.json"
    path.write_text(
        '{"server": {"port": 8088, "rate_limit": {"burst": 7}},'
        ' "grpc": {"host": "h", "reconnect": {"max_attempts": 2}},'
        ' "gateway": {"routing": {"policy": "affinity"}},'
        ' "session": {"max_sessions": 5}, "logging": {"format": "json"}}')
    env = {"GGRMCP_SERVER_REQUEST_TIMEOUT_S": "9.5",
           "GGRMCP_GATEWAY_ROUTING_SPILL_THRESHOLD": "2",
           "GGRMCP_GRPC_PORT": "9000", "GGRMCP_FAILPOINTS": "x",
           "GGRMCP_FLEET_WORKER_MODEL": "tiny-llama"}
    ours = tcfg.load(str(path), environ=env)
    ref = jcfg.load_file(str(path))
    jcfg.apply_env(ref, env)
    for name in ("server", "grpc", "mcp", "session", "tools", "gateway",
                 "fleet", "logging", "metrics"):
        assert (dataclasses.asdict(getattr(ours, name))
                == dataclasses.asdict(getattr(ref, name))), name
    with pytest.raises(ValueError, match="unknown config key: server.nope"):
        tcfg.config_from_dict({"server": {"nope": 1}})
    with pytest.raises(ValueError, match="GGRMCP_SERVER_NOPE"):
        tcfg.load(environ={"GGRMCP_SERVER_NOPE": "1"})


for _name in ("test_core_types", "test_headers", "test_sessions",
              "test_mcp_validation", "test_schema_builder",
              "test_transcoder"):
    torch_ref_cases.collect(torch_ref_cases.port_module(_name), globals())
