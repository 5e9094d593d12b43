"""HTTP → gRPC metadata forwarding policy.

Capability parity with the reference header filter (pkg/headers/filter.go):
precedence is blocked > forward_all > allowlist, case-insensitive by
default; a disabled filter forwards nothing. Fixed vs the reference:
multi-valued headers are preserved (the reference kept only the first
value, pkg/server/handler.go:320-328).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Union

from ggrmcp_tpu_torch.core.config import HeaderForwardingConfig

HeaderValue = Union[str, list[str]]


class HeaderFilter:
    def __init__(self, cfg: HeaderForwardingConfig):
        self.cfg = cfg
        if cfg.case_insensitive:
            self._blocked = {h.lower() for h in cfg.blocked_headers}
            self._allowed = {h.lower() for h in cfg.allowed_headers}
        else:
            self._blocked = set(cfg.blocked_headers)
            self._allowed = set(cfg.allowed_headers)

    def _key(self, name: str) -> str:
        return name.lower() if self.cfg.case_insensitive else name

    def should_forward(self, name: str) -> bool:
        """Policy: disabled→no; blocked always wins; forward_all→yes;
        else allowlist membership (filter.go:22-62)."""
        if not self.cfg.enabled:
            return False
        key = self._key(name)
        if key in self._blocked:
            return False
        if self.cfg.forward_all:
            return True
        return key in self._allowed

    def filter_headers(
        self, headers: Mapping[str, HeaderValue]
    ) -> dict[str, HeaderValue]:
        return {k: v for k, v in headers.items() if self.should_forward(k)}

    def to_grpc_metadata(
        self, headers: Mapping[str, HeaderValue]
    ) -> list[tuple[str, str]]:
        """Flatten filtered headers into gRPC metadata tuples. gRPC
        metadata keys must be lowercase; every value of a multi-valued
        header is forwarded."""
        metadata: list[tuple[str, str]] = []
        for name, value in headers.items():
            if not self.should_forward(name):
                continue
            values: Iterable[str] = value if isinstance(value, list) else [value]
            for v in values:
                metadata.append((name.lower(), v))
        return metadata
