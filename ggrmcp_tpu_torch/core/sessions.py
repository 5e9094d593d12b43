"""Session management: TTL cache of per-client contexts.

Capability parity with the reference session manager
(pkg/session/manager.go): crypto-random IDs, header snapshots, call
counters, fixed-window rate limiting, block/unblock, TTL expiry with
periodic cleanup and a capacity cap. Fixed vs the reference: rate
limiting and block state are actually ENFORCED by the gateway handler
(manager.go:178 was never called), and eviction over capacity is
deterministic (oldest last-access first) rather than best-effort.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Any, Mapping, Optional

from ggrmcp_tpu_torch.core.config import SessionConfig


class SessionContext:
    """One client session (manager.go:16-34 parity)."""

    __slots__ = (
        "id",
        "headers",
        "created_at",
        "last_accessed",
        "call_count",
        "window_start",
        "window_count",
        "blocked",
        "_lock",
    )

    def __init__(self, session_id: str, headers: Mapping[str, Any]):
        now = time.monotonic()
        self.id = session_id
        self.headers: dict[str, Any] = dict(headers)
        self.created_at = now
        self.last_accessed = now
        self.call_count = 0
        self.window_start = now
        self.window_count = 0
        self.blocked = False
        self._lock = threading.Lock()

    def touch(self) -> None:
        with self._lock:
            self.last_accessed = time.monotonic()

    def increment_calls(self) -> int:
        with self._lock:
            self.call_count += 1
            self.last_accessed = time.monotonic()
            return self.call_count

    def update_headers(self, headers: Mapping[str, Any]) -> None:
        with self._lock:
            self.headers.update(headers)

    def check_rate_limit(self, limit_per_minute: int, window_s: float = 60.0) -> bool:
        """Fixed-window limiter (manager.go:178-208). True = allowed."""
        now = time.monotonic()
        with self._lock:
            if now - self.window_start >= window_s:
                self.window_start = now
                self.window_count = 0
            if self.window_count >= limit_per_minute:
                return False
            self.window_count += 1
            return True

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "id": self.id,
                "callCount": self.call_count,
                "ageSeconds": time.monotonic() - self.created_at,
                "idleSeconds": time.monotonic() - self.last_accessed,
                "blocked": self.blocked,
            }


def new_session_id() -> str:
    """16 crypto-random bytes, hex (manager.go:258-265)."""
    return secrets.token_hex(16)


class SessionManager:
    def __init__(self, cfg: Optional[SessionConfig] = None):
        self.cfg = cfg or SessionConfig()
        self._sessions: dict[str, SessionContext] = {}
        self._lock = threading.Lock()
        self._last_cleanup = time.monotonic()

    # -- core ---------------------------------------------------------------

    def get_or_create(self, session_id: str, headers: Mapping[str, Any]) -> SessionContext:
        """Return the live session for `session_id`, or mint a new one.

        An unknown/expired/empty ID yields a fresh session (the caller
        echoes the new ID back via the Mcp-Session-Id header,
        manager.go:69-84 parity).
        """
        self._maybe_cleanup()
        with self._lock:
            sess = self._sessions.get(session_id) if session_id else None
            if sess is not None and not self._expired(sess):
                sess.update_headers(headers)
                sess.touch()
                return sess
            return self._create_locked(headers)

    def create(self, headers: Mapping[str, Any]) -> SessionContext:
        with self._lock:
            return self._create_locked(headers)

    def _create_locked(self, headers: Mapping[str, Any]) -> SessionContext:
        if len(self._sessions) >= self.cfg.max_sessions:
            self._evict_locked()
        sess = SessionContext(new_session_id(), headers)
        self._sessions[sess.id] = sess
        return sess

    def get(self, session_id: str) -> Optional[SessionContext]:
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None or self._expired(sess):
                return None
            return sess

    def get_live(self, session_id: str) -> Optional[SessionContext]:
        """Hot-path lookup: resolve + touch in one lock acquisition.
        Headers keep their creation-time snapshot (manager.go:69-84
        stores headers only when the session is minted)."""
        self._maybe_cleanup()
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None or self._expired(sess):
                return None
        sess.touch()
        return sess

    def delete(self, session_id: str) -> bool:
        with self._lock:
            return self._sessions.pop(session_id, None) is not None

    # -- policy -------------------------------------------------------------

    def check_rate_limit(self, session: SessionContext) -> bool:
        if not self.cfg.rate_limit.enabled:
            return True
        return session.check_rate_limit(self.cfg.rate_limit.requests_per_minute)

    def block(self, session_id: str) -> bool:
        sess = self.get(session_id)
        if sess is None:
            return False
        sess.blocked = True
        return True

    def unblock(self, session_id: str) -> bool:
        sess = self.get(session_id)
        if sess is None:
            return False
        sess.blocked = False
        return True

    # -- lifecycle ----------------------------------------------------------

    def _expired(self, sess: SessionContext) -> bool:
        return time.monotonic() - sess.last_accessed > self.cfg.ttl_s

    def _maybe_cleanup(self) -> None:
        now = time.monotonic()
        if now - self._last_cleanup < self.cfg.cleanup_interval_s:
            return
        with self._lock:
            if now - self._last_cleanup < self.cfg.cleanup_interval_s:
                return
            self._last_cleanup = now
            dead = [sid for sid, s in self._sessions.items() if self._expired(s)]
            for sid in dead:
                del self._sessions[sid]

    def _evict_locked(self) -> None:
        """Evict expired sessions; if still over cap, evict the ~10%
        least-recently-accessed so creation never fails."""
        dead = [sid for sid, s in self._sessions.items() if self._expired(s)]
        for sid in dead:
            del self._sessions[sid]
        if len(self._sessions) < self.cfg.max_sessions:
            return
        by_idle = sorted(self._sessions.values(), key=lambda s: s.last_accessed)
        for sess in by_idle[: max(1, len(by_idle) // 10)]:
            del self._sessions[sess.id]

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            sessions = list(self._sessions.values())
        return {
            "sessionCount": len(sessions),
            "maxSessions": self.cfg.max_sessions,
            "ttlSeconds": self.cfg.ttl_s,
            "totalCalls": sum(s.call_count for s in sessions),
            "blockedCount": sum(1 for s in sessions if s.blocked),
        }
