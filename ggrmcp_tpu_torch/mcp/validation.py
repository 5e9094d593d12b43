"""Request validation and output sanitization.

Capability parity with the reference validator (pkg/mcp/validation.go):
jsonrpc version check, method name charset/length limits, required IDs,
tool-name rules, recursive depth limits, approximate size limits, control
character stripping, and secret redaction in error text.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from ggrmcp_tpu_torch.core.config import ValidationConfig
from ggrmcp_tpu_torch.mcp.types import INVALID_PARAMS, INVALID_REQUEST, MCPError

_METHOD_RE = re.compile(r"^[a-zA-Z0-9_/]+$")
_TOOL_NAME_RE = re.compile(r"^[a-zA-Z0-9_.]+$")

# Redaction of likely secrets in error strings (validation.go:248-271
# semantics): the keyword and the token following it are both masked.
_SECRET_RE = re.compile(
    r"(?i)(password|token|key|secret|credential|auth)(\s*[:=]?\s*)(\S+)"
)

_CONTROL_CHARS_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")


class Validator:
    def __init__(self, cfg: Optional[ValidationConfig] = None):
        self.cfg = cfg or ValidationConfig()

    # -- request-level ------------------------------------------------------

    def validate_request(self, data: Any) -> None:
        """Validate a decoded JSON-RPC request envelope.

        Raises MCPError(INVALID_REQUEST / INVALID_PARAMS) — the code
        travels with the exception, no text matching downstream.
        """
        if not isinstance(data, dict):
            raise MCPError(INVALID_REQUEST, "request must be a JSON object")
        if data.get("jsonrpc") != "2.0":
            raise MCPError(INVALID_REQUEST, "jsonrpc version must be '2.0'")
        method = data.get("method")
        if not isinstance(method, str) or not method:
            raise MCPError(INVALID_REQUEST, "method is required")
        if len(method) > self.cfg.max_method_length:
            raise MCPError(INVALID_REQUEST, "method name too long")
        if not _METHOD_RE.match(method):
            raise MCPError(INVALID_REQUEST, "method contains invalid characters")
        if "id" not in data or data["id"] is None:
            raise MCPError(INVALID_REQUEST, "id is required")
        if not isinstance(data["id"], (str, int, float)):
            raise MCPError(INVALID_REQUEST, "id must be a string or number")
        params = data.get("params")
        if params is not None:
            self.validate_value(params)

    def validate_tool_call_params(self, params: Any) -> tuple[str, dict[str, Any]]:
        """Validate tools/call params; returns (tool_name, arguments)."""
        if not isinstance(params, dict):
            raise MCPError(INVALID_PARAMS, "params must be an object")
        name = params.get("name")
        if not isinstance(name, str) or not name:
            raise MCPError(INVALID_PARAMS, "tool name is required")
        if len(name) > self.cfg.max_tool_name_length:
            raise MCPError(INVALID_PARAMS, "tool name too long")
        if not _TOOL_NAME_RE.match(name):
            raise MCPError(INVALID_PARAMS, "tool name contains invalid characters")
        arguments = params.get("arguments")
        if arguments is None:
            arguments = {}
        if not isinstance(arguments, dict):
            raise MCPError(INVALID_PARAMS, "arguments must be an object")
        self.validate_value(arguments)
        return name, arguments

    # -- structural limits --------------------------------------------------

    def validate_value(self, value: Any) -> None:
        try:
            depth, size = _walk(value)
        except RecursionError:
            raise MCPError(
                INVALID_PARAMS,
                f"params nesting exceeds depth limit {self.cfg.max_nesting_depth}",
            )
        if depth > self.cfg.max_nesting_depth:
            raise MCPError(
                INVALID_PARAMS,
                f"params nesting exceeds depth limit {self.cfg.max_nesting_depth}",
            )
        if size > self.cfg.max_request_bytes:
            raise MCPError(
                INVALID_PARAMS,
                f"params size {size} exceeds limit {self.cfg.max_request_bytes}",
            )


def _walk(value: Any) -> tuple[int, int]:
    """Depth and approximate serialized size in ONE recursive pass
    (the hot path validates every tools/call argument tree; two
    separate walks doubled the cost)."""
    if isinstance(value, str):
        return 0, len(value) + 2
    if isinstance(value, bool) or value is None:
        return 0, 5
    if isinstance(value, (int, float)):
        return 0, 16
    if isinstance(value, dict):
        if not value:
            return 1, 2
        depth = 0
        size = 2
        for k, v in value.items():
            d, s = _walk(v)
            if d > depth:
                depth = d
            size += len(str(k)) + 4 + s
        return 1 + depth, size
    if isinstance(value, (list, tuple)):
        if not value:
            return 1, 2
        depth = 0
        size = 2
        for v in value:
            d, s = _walk(v)
            if d > depth:
                depth = d
            size += s + 1
        return 1 + depth, size
    return 0, 16


# ---------------------------------------------------------------------------
# Sanitization
# ---------------------------------------------------------------------------


def sanitize_string(text: str, max_len: int = 1024) -> str:
    """Strip control characters and cap length (validation.go:235-245)."""
    cleaned = _CONTROL_CHARS_RE.sub("", text)
    if len(cleaned) > max_len:
        cleaned = cleaned[:max_len]
    return cleaned


def sanitize_error(message: str, max_len: int = 1024) -> str:
    """Redact likely secrets, then sanitize (validation.go:248-271)."""
    redacted = _SECRET_RE.sub(lambda m: f"{m.group(1)}{m.group(2)}[REDACTED]", message)
    return sanitize_string(redacted, max_len)
