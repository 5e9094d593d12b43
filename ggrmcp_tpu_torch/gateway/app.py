"""Gateway composition root: wires config, discovery, sessions, handler,
middleware, and the HTTP server (cmd/grmcp/main.go capability parity:
flags → logger → discoverer → sessions → tools → handler → router →
middleware → server → graceful shutdown)."""

from __future__ import annotations

import asyncio
import logging
import os
import signal
from typing import Optional

from aiohttp import web

from ggrmcp_tpu_torch.core.config import Config
from ggrmcp_tpu_torch.core.sessions import SessionManager
from ggrmcp_tpu_torch.gateway.handler import MCPHandler
from ggrmcp_tpu_torch.gateway.metrics import GatewayMetrics
from ggrmcp_tpu_torch.gateway.middleware import default_middlewares
from ggrmcp_tpu_torch.rpc.discovery import ServiceDiscoverer

logger = logging.getLogger("ggrmcp.gateway")


def setup_logging(cfg: Config) -> None:
    level = getattr(logging, cfg.logging.level.upper(), logging.INFO)
    if cfg.logging.format == "json" or os.environ.get(
        "GGRMCP_LOG_JSON"
    ) == "1":
        # Structured one-line JSON records carrying the current trace
        # id from the tracing contextvar — both the gateway and the
        # sidecar run through here, so their logs join /debug/traces,
        # /debug/requests, and /debug/timeline by trace id
        # (utils/jsonlog.py; docs/observability.md).
        from ggrmcp_tpu_torch.utils.jsonlog import JsonFormatter

        handler = logging.StreamHandler()
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler], force=True)
        return
    fmt = (
        '{"ts":"%(asctime)s","level":"%(levelname)s","logger":"%(name)s","msg":"%(message)s"}'
        if cfg.logging.json_output
        else "%(asctime)s %(levelname)-7s %(name)s  %(message)s"
    )
    logging.basicConfig(level=level, format=fmt)


class Gateway:
    """Owns the full gateway stack; start()/stop() or use run()."""

    def __init__(
        self,
        cfg: Config,
        targets: Optional[list[str]] = None,
        discoverer: Optional[ServiceDiscoverer] = None,
        worker_device: Optional[str] = None,
        worker_seed: int = 0,
    ):
        self.cfg = cfg
        self.metrics = GatewayMetrics()
        self.sessions = SessionManager(cfg.session)
        self.discoverer = discoverer or ServiceDiscoverer(
            targets if targets is not None else [cfg.grpc.target], cfg.grpc,
            routing=cfg.gateway.routing,
        )
        self.handler = MCPHandler(cfg, self.discoverer, self.sessions, self.metrics)
        # The aiohttp app (routes + middleware) is only built when that
        # implementation actually serves (start()); the fastlane default
        # doesn't pay for it.
        self.app: Optional[web.Application] = None
        self._runner: Optional[web.AppRunner] = None
        self._site: Optional[web.TCPSite] = None
        self._fastlane = None
        self.port = cfg.server.port
        # Elastic fleet supervisor (serving/fleet.py) — built in
        # start() when cfg.fleet.enabled; its child replicas join the
        # discoverer at runtime via add_backend.
        self.fleet = None
        self._fleet_adapter = None
        # The port's fleet workers serve on this device (None: the card)
        # with weights from this seed (serving/fleet.py handshake).
        self.worker_device = worker_device
        self.worker_seed = worker_seed

    def _build_app(self) -> web.Application:
        app = web.Application(
            middlewares=default_middlewares(self.cfg.server, self.metrics),
            client_max_size=self.cfg.server.max_request_bytes,
        )
        app.router.add_get("/", self.handler.handle_get)
        app.router.add_post("/", self.handler.handle_post)
        app.router.add_route("OPTIONS", "/", self.handler.handle_get)
        app.router.add_get("/health", self.handler.handle_health)
        app.router.add_get("/metrics", self.handler.handle_metrics)
        app.router.add_get("/stats", self.handler.handle_stats)
        app.router.add_get("/debug/traces", self.handler.handle_traces)
        app.router.add_get("/debug/ticks", self.handler.handle_debug_ticks)
        app.router.add_get(
            "/debug/requests", self.handler.handle_debug_requests
        )
        app.router.add_get(
            "/debug/timeline", self.handler.handle_debug_timeline
        )
        app.router.add_get("/debug/memory", self.handler.handle_debug_memory)
        app.router.add_get("/debug/slo", self.handler.handle_debug_slo)
        app.router.add_post(
            "/debug/profile", self.handler.handle_debug_profile
        )
        app.router.add_post("/admin/drain", self.handler.handle_admin_drain)
        app.router.add_post(
            "/admin/undrain", self.handler.handle_admin_undrain
        )
        app.router.add_post("/admin/fleet", self.handler.handle_admin_fleet)
        return app

    async def start(
        self, connect_backends: bool = True, reuse_port: bool = False
    ) -> None:
        if connect_backends and self.discoverer.backends:
            try:
                await self.discoverer.connect(self.cfg.grpc.connect_timeout_s)
            except ConnectionError as exc:
                # Fail-fast startup like the reference (main.go:152-170)
                # unless reconnection is enabled — then serve degraded and
                # let the watchdog recover the backends. A fleet-enabled
                # gateway also starts degraded: its supervisor spawns the
                # replica pool moments later, so dying on an unreachable
                # static placeholder would be a bootstrap dead-end.
                if not (
                    self.cfg.grpc.reconnect.enabled
                    or self.cfg.fleet.enabled
                ):
                    raise
                logger.warning("starting degraded: %s", exc)
        await self.discoverer.discover_services()
        self.discoverer.start_watchdog()
        if self.cfg.fleet.enabled:
            self._start_fleet()

        if self.cfg.server.http_impl == "fastlane":
            from ggrmcp_tpu_torch.gateway.fastlane import FastLaneServer

            self._fastlane = FastLaneServer(self.cfg, self.handler)
            await self._fastlane.start(
                self.cfg.server.host, self.cfg.server.port,
                reuse_port=reuse_port,
            )
            self.port = self._fastlane.port
        else:
            if self.app is None:
                self.app = self._build_app()
            # access_log=None: the fused middleware already logs requests;
            # aiohttp's default access logger would format+emit a second
            # line per request on the hot path.
            self._runner = web.AppRunner(self.app, access_log=None)
            await self._runner.setup()
            self._site = web.TCPSite(
                self._runner, self.cfg.server.host, self.cfg.server.port,
                reuse_port=reuse_port or None,
            )
            await self._site.start()
            for s in self._runner.sites:
                # resolve the real port when configured with 0
                sock = s._server.sockets[0] if s._server and s._server.sockets else None
                if sock is not None:
                    self.port = sock.getsockname()[1]
        logger.info(
            "gateway listening on %s:%d (%d tools, %s)",
            self.cfg.server.host, self.port,
            self.discoverer.get_service_stats()["methodCount"],
            self.cfg.server.http_impl,
        )

    def _start_fleet(self) -> None:
        """Build + start the fleet supervisor (cfg.fleet.enabled):
        child sidecar workers inherit the serving config through the
        GGRMCP_FLEET_WORKER_* env handshake, observation/actuation ride
        the discoverer. Statically configured backends stay OUTSIDE the
        supervisor's pool — it grows/shrinks/heals only replicas it
        spawned (the floor pass bootstraps min_replicas of them)."""
        import os as _os

        from ggrmcp_tpu_torch.serving.fleet import (
            FleetSupervisor,
            GatewayFleetAdapter,
            ProcessReplicaFactory,
            handshake_environ,
        )

        serving = self.cfg.serving
        env = dict(_os.environ)
        env.update(handshake_environ(
            serving, self.worker_device, self.worker_seed))
        self._fleet_adapter = GatewayFleetAdapter(
            self.discoverer, ProcessReplicaFactory(env=env)
        )
        self.fleet = FleetSupervisor(
            self.cfg.fleet, self._fleet_adapter,
            # Replica boots take tens of seconds of JAX warmup; inline
            # applies would wedge every other policy for the duration.
            background_actions=True,
        )
        self.handler.fleet = self.fleet
        self.fleet.start()
        logger.info(
            "fleet supervisor started (min=%d max=%d, interval %.1fs)",
            self.cfg.fleet.min_replicas, self.cfg.fleet.max_replicas,
            self.cfg.fleet.decide_interval_s,
        )

    async def stop(self) -> None:
        """Graceful shutdown with drain (main.go:94-112)."""
        if self.fleet is not None:
            await self.fleet.stop()
            await self._fleet_adapter.close()
            self.handler.fleet = None
            self.fleet = None
            self._fleet_adapter = None
        await self.discoverer.stop_watchdog()
        if self._fastlane is not None:
            await asyncio.wait_for(
                self._fastlane.stop(), timeout=self.cfg.server.shutdown_grace_s
            )
            self._fastlane = None
        if self._runner is not None:
            await asyncio.wait_for(
                self._runner.cleanup(), timeout=self.cfg.server.shutdown_grace_s
            )
        await self.discoverer.close()

    async def run_forever(self, reuse_port: bool = False) -> None:
        await self.start(reuse_port=reuse_port)
        stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_event.set)
            except NotImplementedError:  # pragma: no cover (non-unix)
                pass
        await stop_event.wait()
        logger.info("shutting down")
        await self.stop()


def run(
    cfg: Config,
    targets: Optional[list[str]] = None,
    reuse_port: bool = False,
    worker_device: Optional[str] = None,
    worker_seed: int = 0,
) -> None:
    setup_logging(cfg)
    gateway = Gateway(cfg, targets, worker_device=worker_device,
                      worker_seed=worker_seed)
    asyncio.run(gateway.run_forever(reuse_port=reuse_port))


def _worker_entry(cfg: Config, targets: Optional[list[str]], idx: int) -> None:
    """Module-level target for multiprocessing spawn (must pickle)."""
    logging.getLogger("ggrmcp.gateway").info("worker %d starting", idx)
    run(cfg, targets, reuse_port=True)


def run_multiworker(cfg: Config, targets: Optional[list[str]] = None) -> None:
    """N gateway processes sharing one port via SO_REUSEPORT
    (server.workers > 1): the kernel hashes connections across workers,
    scaling the asyncio gateway over cores the way the Go reference's
    goroutines did. Each worker owns its full stack (discovery,
    sessions, metrics); sessions are worker-local (ServerConfig.workers
    doc). The parent only supervises: SIGTERM/SIGINT fan out to
    workers; any worker death tears the group down (a supervisor/
    orchestrator restarts the process group)."""
    import multiprocessing
    import signal as _signal

    setup_logging(cfg)
    ctx = multiprocessing.get_context("spawn")
    workers = [
        ctx.Process(
            target=_worker_entry, args=(cfg, targets, i), name=f"gw-worker-{i}"
        )
        for i in range(cfg.server.workers)
    ]
    for w in workers:
        w.start()
    logger.info(
        "gateway: %d workers on %s:%d (SO_REUSEPORT)",
        len(workers), cfg.server.host, cfg.server.port,
    )

    def _forward(signum, frame):  # noqa: ARG001
        for w in workers:
            if w.is_alive() and w.pid:
                import os as _os

                _os.kill(w.pid, _signal.SIGTERM)

    _signal.signal(_signal.SIGTERM, _forward)
    _signal.signal(_signal.SIGINT, _forward)
    try:
        while True:
            for w in workers:
                w.join(timeout=0.5)
                if not w.is_alive():
                    if w.exitcode not in (0, -_signal.SIGTERM.value):
                        logger.error(
                            "worker %s died (exit %s); stopping group",
                            w.name, w.exitcode,
                        )
                    _forward(None, None)
                    for rest in workers:
                        rest.join(timeout=cfg.server.shutdown_grace_s)
                    return
    finally:
        for w in workers:
            if w.is_alive():
                w.terminate()
