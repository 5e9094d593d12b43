"""The port's gateway plane against the reference's text.

Every module the port copies from `ggrmcp_tpu` for its gateway (core
types, headers and sessions, the MCP types and validation, the schema
builder, the gRPC connection, descriptors, reflection client, discovery
and router, the timeline, the gateway's metrics, middleware, handler,
fast lane and app, the tracer, the JSON log formatter and the asyncio
shim; the supervisor half of `serving/fleet.py`; the demo backends'
generated messages and the percentile math) equals the reference's
text except for the lines listed here: imports that name the port's
package (checked line by line), the listed blocks that point the
gateway's fleet at the port's worker and those of the port's spans (the
tracer's ring, the gateway's `gateway.http` and `gateway.invoke`, the
timeline's tracks of spans of no call), and three comments that drop the
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
    "rpc/router.py": [], "gateway/__init__.py": [],
    "gateway/metrics.py": [], "gateway/middleware.py": [],
    # The demo backends' messages (generated, byte for byte) and the
    # percentile math.
    "rpc/pb/hello_pb2.py": [], "rpc/pb/complex_pb2.py": [],
    "utils/stats.py": [],
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
    # capture on torch.profiler follows it): its ring keeps the end of
    # what it drops and spans timed elsewhere (`record`, `snapshot`,
    # `reserve`), and the docstring names the port's capture.
    "utils/tracing.py": [
        (
            [
                '  captures a real JAX profiler trace (TensorBoard/XProf-loadable) on',
            ],
            [
                '  captures a `torch.profiler` Chrome trace (Perfetto-loadable) on',
            ],
        ),
        (
            [],
            [
                '- work timed where no `with` block fits (a serving-loop turn, a device',
                "  region resolved after the tick's sync) is kept after the fact",
                "  (`Tracer.record`), its start in wall seconds on the tick records'",
                '  axis; spans of no call carry an empty trace id. The ring keeps the',
                '  latest end among the spans it drops, so a reader of an interval can',
                '  tell it is whole.',
            ],
        ),
        (
            [],
            [
                'import re',
                'import sys',
            ],
        ),
        (
            [],
            [
                '        # The latest wall end among the spans the full ring pushed out:',
                '        # every span that ends after it is still in the ring.',
                '        self.dropped_until = 0.0',
                '',
                '    @property',
                '    def capacity(self) -> int:',
                '        return self._finished.maxlen',
                '',
                '    def reserve(self, capacity: int) -> None:',
                '        """Grow the ring to hold `capacity` spans (it never shrinks)."""',
                '        with self._lock:',
                '            if capacity > self._finished.maxlen:',
                '                self._finished = deque(self._finished, maxlen=capacity)',
                '',
                '    def _keep(self, span: Span) -> None:',
                '        with self._lock:',
                '            ring = self._finished',
                '            if len(ring) == ring.maxlen:',
                '                old = ring[0]',
                '                self.dropped_until = max(',
                '                    self.dropped_until,',
                '                    old.start_unix + old.duration_ms / 1000.0)',
                '            ring.append(span)',
                '',
                '    def record(',
                '        self,',
                '        name: str,',
                '        start_unix: float,',
                '        duration_ms: float,',
                '        trace_id: str = "",',
                '        parent_id: str = "",',
                '        **attrs: Any,',
                '    ) -> Span:',
                '        """Keep a span timed elsewhere: its start in wall seconds and',
                '        its duration. An empty trace id marks work of no call."""',
                '        span = Span(trace_id=trace_id, span_id=new_id(), parent_id=parent_id,',
                '                    name=name, start_unix=start_unix,',
                '                    duration_ms=duration_ms, attrs=attrs)',
                '        self._keep(span)',
                '        return span',
            ],
        ),
        (
            [],
            [
                '        profiled = profiler_range(name)',
            ],
        ),
        (
            [],
            [
                '            if profiled is not None:',
                '                profiled.__exit__(None, None, None)',
            ],
        ),
        (
            [
                '            with self._lock:',
                '                self._finished.append(span)',
            ],
            [
                '            self._keep(span)',
            ],
        ),
        (
            [],
            [
                '    def snapshot(self) -> tuple[list[Span], float]:',
                '        """The ring\'s spans, oldest kept first, and `dropped_until`."""',
                '        with self._lock:',
                '            return list(self._finished), self.dropped_until',
                '',
            ],
        ),
        (
            [],
            [
                '            self.dropped_until = 0.0',
            ],
        ),
        (
            [],
            [
                'def profiler_range(name: str):',
                '    """While a torch profiler records, an entered `record_function(name)`',
                '    range (the caller exits it when the work ends), so that a capture on',
                '    this thread shows the span; None otherwise. torch is looked up, never',
                '    imported: the gateway runs without it."""',
                '    profiler = sys.modules.get("torch.autograd.profiler")',
                '    if profiler is None or not profiler._is_profiler_enabled:',
                '        return None',
                '    rf = profiler.record_function(name)',
                '    rf.__enter__()',
                '    return rf',
                '',
                '',
            ],
        ),
    ],
    # The port's spans on the wall axis: `gateway.http` in both HTTP
    # servers (the complete body to the written response), opened by
    # the transports and named by dispatch, `gateway.invoke` around the
    # backend call with the placement's `target`, the debug endpoints'
    # caps at the ring's capacity, and the timeline's tracks for spans
    # of no call.
    "gateway/fastlane.py": [
        (
            [
                '        transport) around the shared dispatch core."""',
            ],
            [
                '        transport) around the shared dispatch core, in one `gateway.http`',
                '        span from the complete body to the written response."""',
                '        with self.handler.http_span(',
                '                headers.get(tracing.TRACE_HEADER)) as trace_id_in:',
                '            return await self._post_body(conn, headers, pairs, body,',
                '                                         trace_id_in)',
                '',
                '    async def _post_body(',
                '        self,',
                '        conn: FastLaneProtocol,',
                '        headers: dict[str, str],',
                '        pairs: list[tuple[str, str]],',
                '        body: bytes,',
                '        trace_id_in: str,',
                '    ) -> int:',
            ],
        ),
        (
            [
                '            trace_id_in=headers.get(tracing.TRACE_HEADER),',
            ],
            [
                '            trace_id_in=trace_id_in,',
            ],
        ),
    ],
    "gateway/handler.py": [
        (
            [],
            [
                'import contextlib',
            ],
        ),
        (
            [],
            [
                '    @staticmethod',
                '    @contextlib.contextmanager',
                '    def http_span(trace_id_in: Optional[str]):',
                '        """`gateway.http`: one POST from its complete body to its written',
                '        response (aiohttp: handed back for aiohttp to write), under the',
                "        caller's trace id or a new one, which it yields; `dispatch` names",
                '        its method on it."""',
                '        trace_id = trace_id_in or tracing.new_id()',
                '        with tracing.tracer.span("gateway.http", trace_id=trace_id):',
                '            yield trace_id',
                '',
            ],
        ),
        (
            [],
            [
                '        body = await request.read()',
                '        with self.http_span(request.headers.get(tracing.TRACE_HEADER)) as trace_id:',
                '            return await self._post(request, body, trace_id)',
                '',
                '    async def _post(',
                '        self, request: web.Request, body: bytes, trace_id_in: str',
                '    ) -> web.StreamResponse:',
            ],
        ),
        (
            [
                '            body = await request.read()',
            ],
            [],
        ),
        (
            [
                '            trace_id_in=request.headers.get(tracing.TRACE_HEADER),',
            ],
            [
                '            trace_id_in=trace_id_in,',
            ],
        ),
        (
            [
                '        # One span per request; the incoming x-trace-id header (if any)',
                "        # continues the caller's trace, and the id is echoed back.",
            ],
            [
                "        # One span per request, the transport's `gateway.http`: the",
                "        # incoming x-trace-id header (if any) continues the caller's",
                '        # trace, and the id is echoed back.',
            ],
        ),
        (
            [],
            [
                '        tracing.tracer.current().set(method=method, session=session.id[:8])',
            ],
        ),
        (
            [
                '            with tracing.tracer.span(',
                '                f"gateway.{method}", trace_id=trace_id, session=session.id[:8]',
                '            ):',
                '                if method == "initialize":',
                '                    result = self._handle_initialize()',
                '                elif method == "ping":',
                '                    result = {}',
                '                elif method == "tools/list":',
                '                    result = self._handle_tools_list()',
                '                elif method == "tools/call":',
                '                    if sse is not None:',
                '                        await self._stream_tool_call(',
                '                            request_id, session, params, sse, trace_id',
                '                        )',
                '                        return None, session, trace_id',
                '                    result = await self._handle_tools_call(session, params)',
                '                elif method == "prompts/list":',
                '                    result = {"prompts": []}',
                '                elif method == "resources/list":',
                '                    result = {"resources": []}',
                '                else:',
                '                    raise mcp.MCPError(',
                '                        mcp.METHOD_NOT_FOUND, f"method not found: {method}"',
            ],
            [
                '            if method == "initialize":',
                '                result = self._handle_initialize()',
                '            elif method == "ping":',
                '                result = {}',
                '            elif method == "tools/list":',
                '                result = self._handle_tools_list()',
                '            elif method == "tools/call":',
                '                if sse is not None:',
                '                    await self._stream_tool_call(',
                '                        request_id, session, params, sse, trace_id',
            ],
        ),
        (
            [],
            [
                '                    return None, session, trace_id',
                '                result = await self._handle_tools_call(session, params)',
                '            elif method == "prompts/list":',
                '                result = {"prompts": []}',
                '            elif method == "resources/list":',
                '                result = {"resources": []}',
                '            else:',
                '                raise mcp.MCPError(',
                '                    mcp.METHOD_NOT_FOUND, f"method not found: {method}"',
                '                )',
            ],
        ),
        (
            [
                '                async for chunk in self.discoverer.invoke_stream_by_tool(',
                '                    tool_name, arguments, headers, timeout',
                '                ):',
                '                    chunks.append(chunk)',
            ],
            [
                '                with tracing.tracer.span("gateway.invoke", tool=tool_name):',
                '                    async for chunk in self.discoverer.invoke_stream_by_tool(',
                '                        tool_name, arguments, headers, timeout',
                '                    ):',
                '                        chunks.append(chunk)',
            ],
        ),
        (
            [
                '                payload = await self.discoverer.invoke_by_tool(',
                '                    tool_name, arguments, headers, timeout',
                '                )',
            ],
            [
                '                with tracing.tracer.span("gateway.invoke", tool=tool_name):',
                '                    payload = await self.discoverer.invoke_by_tool(',
                '                        tool_name, arguments, headers, timeout',
                '                    )',
            ],
        ),
        (
            [
                '            async for chunk in self.discoverer.invoke_stream_by_tool(',
                '                tool_name, arguments, headers, self.cfg.server.request_timeout_s',
                '            ):',
                '                chunks.append(chunk)',
                '                await sse.event(',
                '                    "chunk",',
                '                    {"content": mcp.text_content(json.dumps(chunk, ensure_ascii=False))},',
                '                )',
            ],
            [
                '            with tracing.tracer.span("gateway.invoke", tool=tool_name):',
                '                async for chunk in self.discoverer.invoke_stream_by_tool(',
                '                    tool_name, arguments, headers, self.cfg.server.request_timeout_s',
                '                ):',
                '                    chunks.append(chunk)',
                '                    await sse.event(',
                '                        "chunk",',
                '                        {"content": mcp.text_content(json.dumps(chunk, ensure_ascii=False))},',
                '                    )',
            ],
        ),
        (
            [
                '        return {"spans": tracing.tracer.recent(max(1, min(n, 512)))}',
            ],
            [
                '        return {"spans": tracing.tracer.recent(',
                '            max(1, min(n, tracing.tracer.capacity)))}',
            ],
        ),
        (
            [
                '            tracing.tracer.recent(min(n, 512)), entries',
            ],
            [
                '            tracing.tracer.recent(min(n, tracing.tracer.capacity)), entries',
            ],
        ),
    ],
    "rpc/discovery.py": [
        (
            [
                'from ggrmcp_tpu.utils import failpoints',
            ],
            [
                'from ggrmcp_tpu_torch.utils import failpoints, tracing',
            ],
        ),
        (
            [
                '        watchdog revives it."""',
            ],
            [
                "        watchdog revives it. Every placement passes here: the call's",
                '        span (the gateway\'s `gateway.invoke`) gets its target."""',
                '        span = tracing.tracer.current()',
                '        if span is not None:',
                '            span.set(target=backend.target)',
            ],
        ),
    ],
    "serving/timeline.py": [
        (
            [
                'trace id, so concurrent calls never overlap on a track; each backend is',
            ],
            [
                'trace id, so concurrent calls never overlap on a track; spans of no call',
                "(the co-launched batcher's turns and admissions, its device regions)",
                'sit on the first backend\'s "<family> spans" threads; each backend is',
            ],
        ),
        (
            [],
            [
                '# The first "<family> spans" thread of a backend\'s row: past its tick',
                '# sources, before its compile (999) and request (1000+) rows.',
                '_TID_BATCHER = 900',
            ],
        ),
        (
            [
                'def _span_events(spans: list, events: list) -> None:',
            ],
            [
                'def _span_events(spans: list, events: list, batcher_pid: int) -> None:',
            ],
        ),
        (
            [
                '    trace nest by containment)."""',
            ],
            [
                '    trace nest by containment). A span of no call (empty trace id) goes',
                '    to `batcher_pid`\'s thread of its family (the name\'s first part)."""',
            ],
        ),
        (
            [],
            [
                '    families: dict[str, int] = {}',
            ],
        ),
        (
            [
                '        trace_id = str(span.get("traceId", "")) or "-"',
                '        tid = tids.get(trace_id)',
            ],
            [
                '        name = str(span.get("name", "span"))',
                '        trace_id = str(span.get("traceId", ""))',
                '        pid = _PID_GATEWAY',
                '        if not trace_id:',
                '            family = name.split(".")[0]',
                '            pid, tid = batcher_pid, families.get(family)',
                '            if tid is None:',
                '                tid = families[family] = _TID_BATCHER + len(families)',
                '                events.append(_meta(pid, tid, "thread_name",',
                '                                    f"{family} spans"))',
                '            trace_id = "-"',
                '        else:',
                '            tid = tids.get(trace_id)',
            ],
        ),
        (
            [
                '            "name": str(span.get("name", "span")),',
            ],
            [
                '            "name": name,',
            ],
        ),
        (
            [
                '            "pid": _PID_GATEWAY, "tid": tid,',
            ],
            [
                '            "pid": pid, "tid": tid,',
            ],
        ),
        (
            [
                '    _span_events(spans or [], events)',
            ],
            [
                '    live = [i for i, e in enumerate(backends or []) if "error" not in e]',
                '    _span_events(spans or [], events,',
                '                 _PID_GATEWAY + 1 + live[0] if live else _PID_GATEWAY)',
            ],
        ),
    ],
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


@pytest.mark.parametrize("path", ["rpc/pb/hello_pb2.py",
                                  "rpc/pb/complex_pb2.py"])
def test_generated_messages_are_the_reference_bytes(path):
    """Byte for byte: their descriptors equal the reference's."""
    with open(os.path.join(REPO, "ggrmcp_tpu", path), "rb") as fh:
        want = fh.read()
    with open(os.path.join(REPO, "ggrmcp_tpu_torch", path), "rb") as fh:
        assert fh.read() == want


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
