"""Shared method model: the unit of discovery and invocation.

Capability parity with the reference's shared method model
(pkg/types/service.go:15-61): a discovered gRPC method is carried through
the system as a `MethodInfo` — name, service, descriptors, streaming
flags, doc comments — and is addressed by a deterministically mangled
tool name.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from google.protobuf import descriptor as _descriptor


@dataclasses.dataclass
class SourceLocation:
    """Proto source position of a discovered symbol (file + line/column)."""

    file: str = ""
    line: int = 0
    column: int = 0


@dataclasses.dataclass
class MethodInfo:
    """Everything the gateway knows about one callable gRPC method.

    Capability parity: pkg/types/service.go:15-43.
    """

    name: str
    full_name: str
    service_name: str
    input_type: str = ""
    output_type: str = ""
    description: str = ""
    service_description: str = ""
    # protobuf Descriptor objects for dynamic message construction.
    input_descriptor: Optional[_descriptor.Descriptor] = None
    output_descriptor: Optional[_descriptor.Descriptor] = None
    is_client_streaming: bool = False
    is_server_streaming: bool = False
    source_location: Optional[SourceLocation] = None
    # Extra metadata (e.g. tensor endpoint hints from TPU sidecars).
    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def tool_name(self) -> str:
        return generate_tool_name(self.service_name, self.name)

    @property
    def grpc_path(self) -> str:
        """Wire path for invocation: /package.Service/Method.

        When the service name was compatibility-trimmed (FDS loading,
        see rpc/descriptors.py), the wire path still uses the original
        fully-qualified name — the trim is for tool naming only.
        """
        svc = self.options.get("untrimmed_service_name", self.service_name)
        return f"/{svc}/{self.name}"

    @property
    def is_streaming(self) -> bool:
        return self.is_client_streaming or self.is_server_streaming


_TOOL_NAME_RE = re.compile(r"^[a-zA-Z0-9_.]+$")


def generate_tool_name(service_full_name: str, method_name: str) -> str:
    """Mangle `pkg.Service` + `Method` into an MCP tool name.

    Behavior carried over verbatim from the reference
    (pkg/types/service.go:53-61): lowercase the full service name,
    replace dots with underscores, append ``_`` + lowercased method.
    Example: ``hello.HelloService`` + ``SayHello`` →
    ``hello_helloservice_sayhello``.
    """
    service = service_full_name.lower().replace(".", "_")
    return f"{service}_{method_name.lower()}"


def is_valid_tool_name(name: str) -> bool:
    """Tool names must be non-empty, contain an underscore separator, and
    use only word characters (pkg/tools/builder.go:103-122 semantics)."""
    return bool(name) and "_" in name and bool(_TOOL_NAME_RE.match(name))
