"""Co-launch: the MCP gateway and the port's sidecar, supervised, on one
event loop in one process (`python -m ggrmcp_tpu_torch gateway --tpu`).

Counterpart of `ggrmcp_tpu/serving/launcher.py`, in its layout: the
gateway (gateway/app.py) finds the co-launched sidecar through its
ordinary discoverer, so to an MCP client it is one more discovered gRPC
backend.

- Transport (`resolve_colaunch_transport`, the reference's rule): the
  gateway→sidecar hop rides a private unix socket,
  `{tempdir}/ggrmcp-sidecar-{pid}.sock`, unless `serving.port` is pinned
  (something external dials it over TCP) or `serving.uds_path` names the
  socket.
- Supervision (`Colaunch._supervise`, the reference's
  `_supervise_sidecar`): a watcher awaits the sidecar server's
  termination and restarts it on the same target with the fleet's
  backoff, min(backoff_max_s, backoff_base_s * 2^attempt) * (1 +
  backoff_jitter * U), U from `random.Random(0)`, then nudges the
  discoverer (reconnect the backend, rediscover) instead of waiting for
  its watchdog; after `restart_max_attempts` failed restarts it raises
  `SidecarSupervisionError`. On top of the reference's rules, the dead
  sidecar's engine is dropped (and the card's cache emptied) before the
  replacement is built, so a restart never needs two models' memory,
  and the discoverer's watchdog pauses from the death to the nudge: its
  own reconnect of the backend could close the channel under the
  nudge's reflection call, which then never returns.
- The replica fleet (`fleet.enabled`): the gateway's own supervisor
  spawns workers of this port (serving/fleet.py) on the co-launch's
  device and seed; the co-launched sidecar stays a static backend
  outside the supervisor's pool, as in the reference.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import os
import random
import signal
import tempfile
from typing import Callable, Optional, Sequence

import torch

from ggrmcp_tpu_torch.core.config import Config, ServingConfig
from ggrmcp_tpu_torch.gateway.app import Gateway, setup_logging

logger = logging.getLogger("ggrmcp.torch.launcher")


class SidecarSupervisionError(RuntimeError):
    """The co-launched sidecar died and could not be restarted within
    the bounded retry budget — the launcher exits typed rather than
    serving a dead backend forever."""

    def __init__(self, attempts: int, last_error: str):
        super().__init__(
            f"co-launched sidecar died and {attempts} restart attempts "
            f"failed (last: {last_error}); exiting — a gateway without "
            f"its sidecar serves nothing but errors"
        )
        self.attempts = attempts


def resolve_colaunch_transport(cfg: Config) -> None:
    """Pick the gateway→sidecar hop for co-launch, in place: a private
    UDS unless `serving.colaunch_uds` is off, `serving.uds_path` is set
    or `serving.port` is pinned off its default (something external
    dials it over TCP). Re-validates the serving config, so a temp
    directory too long for AF_UNIX fails here, by name."""
    serving = cfg.serving
    if (serving.colaunch_uds and not serving.uds_path
            and serving.port == ServingConfig().port):
        path = os.path.join(tempfile.gettempdir(),
                            f"ggrmcp-sidecar-{os.getpid()}.sock")
        cfg.serving = dataclasses.replace(serving, uds_path=path)


def free_device_memory() -> None:
    """Collect a dropped engine's tensors and return the card's cached
    blocks, so that a replacement can take the same memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Colaunch:
    """The sidecar (built by `sidecar_factory`, default the port's
    Sidecar over `cfg.serving` on `device`, after
    `resolve_colaunch_transport`) and the gateway over it plus
    `extra_targets` (external backends that were given explicitly), on
    `cfg.server.port` (0 takes a free port; `port` reads it). `start()`,
    then `wait()` (raises when the sidecar is given up), and always
    `stop()`."""

    def __init__(
        self,
        cfg: Config,
        extra_targets: Sequence[str] = (),
        sidecar_factory: Optional[Callable[[], object]] = None,
        device=None,
        seed: int = 0,
    ):
        self.cfg = cfg
        if sidecar_factory is None:
            from ggrmcp_tpu_torch.serving.sidecar import Sidecar

            resolve_colaunch_transport(cfg)

            def sidecar_factory() -> object:
                return Sidecar(cfg.serving, seed=seed, device=device)

        self._factory = sidecar_factory
        self._device = device
        self._seed = seed
        self._extra = list(extra_targets)
        self.sidecar = None
        self.gateway: Optional[Gateway] = None
        self.restarts = 0
        self._supervisor: Optional[asyncio.Task] = None

    @property
    def target(self) -> str:
        return self.sidecar.target if self.sidecar is not None else ""

    @property
    def port(self) -> int:
        return self.gateway.port

    async def start(self) -> None:
        self.sidecar = self._factory()
        await self.sidecar.start()
        targets = [self.sidecar.target]
        targets += [t for t in self._extra if t not in targets]
        logger.info("co-launched sidecar on %s; gateway backends: %s",
                    self.sidecar.target, targets)
        self.gateway = Gateway(self.cfg, targets=targets,
                               worker_device=self._device,
                               worker_seed=self._seed)
        await self.gateway.start()
        self._supervisor = asyncio.get_running_loop().create_task(
            self._supervise())

    async def wait(self) -> None:
        """Until the sidecar is given up (SidecarSupervisionError);
        never returns normally."""
        await self._supervisor

    async def _supervise(self) -> None:
        """Restart the sidecar with backoff when it dies, then nudge the
        discoverer. Runs until cancelled (stop() cancels it BEFORE
        stopping the sidecar, so a deliberate stop is never mistaken for
        a death)."""
        fleet = self.cfg.fleet
        rng = random.Random(0)
        while True:
            # Shielded: cancelling a wait_for_termination cancels the
            # server's own shutdown future, and stop() then fails.
            await asyncio.shield(self.sidecar.server.wait_for_termination())
            logger.error(
                "co-launched sidecar on %s terminated unexpectedly; "
                "restarting (max %d attempts)",
                self.sidecar.target, fleet.restart_max_attempts,
            )
            # The discoverer's watchdog pauses until the replacement is
            # nudged: its reconnect of the same backend would close the
            # channel under the nudge's reflection call, whose write then
            # waits forever for metadata the closed call never sends.
            discoverer = self.gateway.discoverer
            await discoverer.stop_watchdog()
            try:
                await self._restart(fleet, rng)
            finally:
                discoverer.start_watchdog()

    async def _restart(self, fleet, rng: random.Random) -> None:
        """Replace the dead sidecar, with backoff, and nudge the
        discoverer; raises SidecarSupervisionError when every attempt
        failed."""
        last_error = "unknown"
        for attempt in range(fleet.restart_max_attempts):
            delay = min(
                fleet.backoff_max_s,
                fleet.backoff_base_s * (2.0 ** attempt),
            ) * (1.0 + fleet.backoff_jitter * rng.random())
            await asyncio.sleep(delay)
            try:
                await self._drop_sidecar(dead=True)
                replacement = self._factory()
                await replacement.start()
                self.sidecar = replacement
                await self._nudge(replacement.target)
                self.restarts += 1
                logger.warning(
                    "co-launched sidecar restarted on %s (attempt "
                    "%d/%d)", replacement.target, attempt + 1,
                    fleet.restart_max_attempts,
                )
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — retried, typed below
                last_error = str(exc)
                logger.error(
                    "sidecar restart attempt %d/%d failed: %s",
                    attempt + 1, fleet.restart_max_attempts, exc,
                )
        raise SidecarSupervisionError(fleet.restart_max_attempts, last_error)

    async def _nudge(self, target: str) -> None:
        """Reconnect the backend on the (unchanged) target and
        rediscover, so methods and roles re-stamp now rather than at the
        discoverer's next watchdog period."""
        discoverer = self.gateway.discoverer
        backend = next(
            (b for b in discoverer.backends if b.target == target), None)
        if backend is not None:
            await backend.connect(self.cfg.grpc.connect_timeout_s)
        await discoverer.discover_services()

    async def _drop_sidecar(self, dead: bool) -> None:
        """Stop the current sidecar (a `dead` one may fail to) and free
        its engine's device memory."""
        sidecar, self.sidecar = self.sidecar, None
        if sidecar is not None:
            try:
                await sidecar.stop()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a dead server may refuse
                if not dead:
                    raise
                logger.debug("stopping the dead sidecar", exc_info=True)
            del sidecar
        # The stop's finished tasks still hold the dead engine (through
        # their done callbacks' handles) until the loop runs them once.
        await asyncio.sleep(0)
        free_device_memory()

    async def stop(self) -> None:
        """Cancel supervision, stop the gateway (and its fleet), then
        stop the sidecar (its socket file goes) and release it."""
        if self._supervisor is not None and not self._supervisor.done():
            self._supervisor.cancel()
            try:
                await self._supervisor
            except asyncio.CancelledError:
                pass
        if self.gateway is not None:
            await self.gateway.stop()
            self.gateway = None
        await self._drop_sidecar(dead=False)


async def run_colaunch(colaunch: Colaunch, stop: asyncio.Event) -> None:
    """Start `colaunch` and serve until `stop` is set (returns) or the
    sidecar is given up (raises); it is stopped either way."""
    try:
        await colaunch.start()
        waiter = asyncio.get_running_loop().create_task(colaunch.wait())
        stopper = asyncio.get_running_loop().create_task(stop.wait())
        try:
            await asyncio.wait({waiter, stopper},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            stopper.cancel()
            if not waiter.done():
                waiter.cancel()
        if waiter.done() and not waiter.cancelled():
            waiter.result()
    finally:
        await colaunch.stop()


async def _run(cfg: Config, extra_targets: Sequence[str],
               sidecar_factory: Optional[Callable[[], object]] = None,
               device=None, seed: int = 0) -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await run_colaunch(
        Colaunch(cfg, extra_targets, sidecar_factory, device, seed), stop)


def run_gateway_with_sidecar(cfg: Config,
                             extra_targets: Optional[Sequence[str]] = None,
                             device=None, seed: int = 0) -> None:
    setup_logging(cfg)
    asyncio.run(_run(cfg, extra_targets or [], device=device, seed=seed))
