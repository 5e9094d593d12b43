"""gRPC channel management: single channels and health-checked pools.

Capability parity with the reference connection layer
(pkg/grpc/connection.go): insecure dial with keepalive and message-size
options, connectivity-state health checking with a bounded wait, and
reconnect. Multi-backend pooling with per-endpoint health and a
reconnect watchdog lives in rpc/discovery.py (Backend +
ServiceDiscoverer), built on this single-channel manager.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import grpc
import grpc.aio

from ggrmcp_tpu_torch.core.config import GRPCConfig

logger = logging.getLogger("ggrmcp.rpc.connection")

_HEALTHY_STATES = (
    grpc.ChannelConnectivity.READY,
    grpc.ChannelConnectivity.IDLE,
)


def _channel_options(cfg: GRPCConfig) -> list[tuple[str, int]]:
    return [
        ("grpc.max_send_message_length", cfg.max_message_bytes),
        ("grpc.max_receive_message_length", cfg.max_message_bytes),
        ("grpc.keepalive_time_ms", int(cfg.keepalive.time_s * 1000)),
        ("grpc.keepalive_timeout_ms", int(cfg.keepalive.timeout_s * 1000)),
        (
            "grpc.keepalive_permit_without_calls",
            1 if cfg.keepalive.permit_without_stream else 0,
        ),
    ]


class ChannelManager:
    """Owns ONE grpc.aio channel to a target (connection.go:19-106 parity)."""

    def __init__(self, target: str, cfg: Optional[GRPCConfig] = None):
        self.cfg = cfg or GRPCConfig()
        self.target = target
        self._channel: Optional[grpc.aio.Channel] = None
        self._lock = asyncio.Lock()

    async def connect(self, timeout_s: Optional[float] = None) -> grpc.aio.Channel:
        """Dial and wait for READY (connection.go:34-72)."""
        timeout_s = timeout_s if timeout_s is not None else self.cfg.connect_timeout_s
        async with self._lock:
            if self._channel is not None:
                await self._channel.close()
            channel = grpc.aio.insecure_channel(
                self.target, options=_channel_options(self.cfg)
            )
            try:
                await asyncio.wait_for(channel.channel_ready(), timeout=timeout_s)
            except asyncio.TimeoutError:
                # Close the half-open channel so no background connect
                # attempts linger and `channel`/`is_connected` report
                # disconnected.
                self._channel = None
                await channel.close()
                raise ConnectionError(
                    f"timed out connecting to {self.target} after {timeout_s}s"
                )
            self._channel = channel
            return channel

    @property
    def channel(self) -> grpc.aio.Channel:
        if self._channel is None:
            raise ConnectionError(f"not connected to {self.target}")
        return self._channel

    def is_connected(self) -> bool:
        """READY or IDLE counts as connected (connection.go:90-100)."""
        if self._channel is None:
            return False
        return self._channel.get_state() in _HEALTHY_STATES

    async def health_check(self, timeout_s: float = 5.0) -> bool:
        """Connectivity-state health probe (connection.go:116-142): reject
        TRANSIENT_FAILURE/SHUTDOWN outright; otherwise poke the channel
        and wait up to `timeout_s` for READY."""
        if self._channel is None:
            return False
        state = self._channel.get_state(try_to_connect=True)
        if state == grpc.ChannelConnectivity.READY:
            return True
        if state in (
            grpc.ChannelConnectivity.TRANSIENT_FAILURE,
            grpc.ChannelConnectivity.SHUTDOWN,
        ):
            return False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                await asyncio.wait_for(
                    self._channel.wait_for_state_change(state),
                    timeout=deadline - time.monotonic(),
                )
            except asyncio.TimeoutError:
                return False
            state = self._channel.get_state()
            if state == grpc.ChannelConnectivity.READY:
                return True
            if state in (
                grpc.ChannelConnectivity.TRANSIENT_FAILURE,
                grpc.ChannelConnectivity.SHUTDOWN,
            ):
                return False
        return False

    async def reconnect(self) -> grpc.aio.Channel:
        return await self.connect()

    async def close(self) -> None:
        async with self._lock:
            if self._channel is not None:
                await self._channel.close()
                self._channel = None
