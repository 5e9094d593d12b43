"""MCP / JSON-RPC 2.0 wire types.

Capability parity with the reference's wire model (pkg/mcp/types.go):
string-or-number request IDs, standard JSON-RPC error codes, content
blocks, tool descriptors with input+output schemas, initialize results.
Implemented as plain dataclasses with explicit (de)serialization — the
hot path works on dicts to avoid double conversion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union

# JSON-RPC 2.0 standard error codes (pkg/mcp/types.go:66-75 parity).
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603
# Implementation-defined server-error range (-32000..-32099): the
# serving backend shed this request (bounded admission full). The HTTP
# transports map this code to 429 + Retry-After; the error's `data`
# carries {"retryAfterS": n} for JSON-RPC-level clients.
OVERLOADED = -32029

JSONRPC_VERSION = "2.0"


def overload_retry_after_s(response: Any) -> Optional[float]:
    """Seconds-to-retry if `response` is an OVERLOADED JSON-RPC error
    dict, else None — the one place transports decide '429 or not'."""
    if not isinstance(response, dict):
        return None
    error = response.get("error")
    if not isinstance(error, dict) or error.get("code") != OVERLOADED:
        return None
    data = error.get("data")
    retry = data.get("retryAfterS", 1) if isinstance(data, dict) else 1
    try:
        return max(0.0, float(retry))
    except (TypeError, ValueError):
        return 1.0

# A request ID is a string or a number (never null on requests).
RequestID = Union[str, int, float]


class MCPError(Exception):
    """A JSON-RPC level error with a code; raised inside handlers and
    mapped structurally to an RPCError — never by substring matching on
    message text (fixing pkg/server/handler.go:118-125)."""

    def __init__(self, code: int, message: str, data: Any = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data

    def to_dict(self) -> dict[str, Any]:
        err: dict[str, Any] = {"code": self.code, "message": self.message}
        if self.data is not None:
            err["data"] = self.data
        return err


@dataclass
class RPCError:
    code: int
    message: str
    data: Any = None

    def to_dict(self) -> dict[str, Any]:
        err: dict[str, Any] = {"code": self.code, "message": self.message}
        if self.data is not None:
            err["data"] = self.data
        return err


@dataclass
class JSONRPCRequest:
    jsonrpc: str = JSONRPC_VERSION
    method: str = ""
    id: Optional[RequestID] = None
    params: Any = None

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "JSONRPCRequest":
        return cls(
            jsonrpc=data.get("jsonrpc", ""),
            method=data.get("method", ""),
            id=data.get("id"),
            params=data.get("params"),
        )

    @property
    def is_notification(self) -> bool:
        return self.id is None


def make_response(id_: Optional[RequestID], result: Any) -> dict[str, Any]:
    return {"jsonrpc": JSONRPC_VERSION, "id": id_, "result": result}


def make_error_response(
    id_: Optional[RequestID], code: int, message: str, data: Any = None
) -> dict[str, Any]:
    resp: dict[str, Any] = {
        "jsonrpc": JSONRPC_VERSION,
        "id": id_,
        "error": {"code": code, "message": message},
    }
    if data is not None:
        resp["error"]["data"] = data
    return resp


# ---------------------------------------------------------------------------
# Content blocks (pkg/mcp/types.go:119-159 parity)
# ---------------------------------------------------------------------------


def text_content(text: str) -> dict[str, Any]:
    return {"type": "text", "text": text}


def image_content(data_b64: str, mime_type: str) -> dict[str, Any]:
    return {"type": "image", "data": data_b64, "mimeType": mime_type}


def audio_content(data_b64: str, mime_type: str) -> dict[str, Any]:
    return {"type": "audio", "data": data_b64, "mimeType": mime_type}


def tool_call_result(
    content: list[dict[str, Any]], is_error: bool = False
) -> dict[str, Any]:
    result: dict[str, Any] = {"content": content}
    if is_error:
        result["isError"] = True
    return result


def tool_call_error(message: str) -> dict[str, Any]:
    """Backend failures surface as IsError tool results, NOT protocol
    errors (behavior carried over from pkg/server/handler.go:252-259)."""
    return tool_call_result([text_content(message)], is_error=True)


# ---------------------------------------------------------------------------
# Tools and capabilities
# ---------------------------------------------------------------------------


@dataclass
class Tool:
    name: str
    description: str
    input_schema: dict[str, Any]
    output_schema: Optional[dict[str, Any]] = None
    annotations: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "description": self.description,
            "inputSchema": self.input_schema,
        }
        if self.output_schema is not None:
            d["outputSchema"] = self.output_schema
        if self.annotations:
            d["annotations"] = self.annotations
        return d


def server_capabilities(
    list_changed: bool = False, streaming: bool = False
) -> dict[str, Any]:
    caps: dict[str, Any] = {
        "tools": {"listChanged": list_changed},
        "prompts": {"listChanged": False},
        "resources": {"subscribe": False, "listChanged": False},
    }
    if streaming:
        caps["experimental"] = {"streaming": True}
    return caps


def initialize_result(
    protocol_version: str, server_name: str, server_version: str
) -> dict[str, Any]:
    return {
        "protocolVersion": protocol_version,
        "capabilities": server_capabilities(),
        "serverInfo": {"name": server_name, "version": server_version},
    }


@dataclass
class ValidationError(Exception):
    field_name: str
    message: str

    def __str__(self) -> str:
        return f"{self.field_name}: {self.message}"
