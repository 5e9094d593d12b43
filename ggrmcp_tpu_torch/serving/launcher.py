"""Co-launch: the port's sidecar, supervised, behind the MCP gateway in
one process tree.

Counterpart of `ggrmcp_tpu/serving/launcher.py`, with the layout
inverted because the port never imports the JAX package: the sidecar
runs in THIS process and the unchanged gateway runs as a child process,
`python -m ggrmcp_tpu gateway --backend unix:PATH ...`, named by its
module path and never imported here.

- Transport (`resolve_colaunch_transport`, the reference's rule): the
  gateway→sidecar hop rides a private unix socket,
  `{tempdir}/ggrmcp-sidecar-{pid}.sock`, unless `serving.port` is pinned
  (something external dials it over TCP) or `serving.uds_path` names the
  socket.
- Supervision: a watcher awaits the sidecar server's termination and
  restarts it on the same target with the fleet's backoff,
  min(backoff_max_s, backoff_base_s * 2^attempt) * (1 + backoff_jitter
  * U), U from `random.Random(0)`; after `restart_max_attempts` failed
  restarts it raises `SidecarSupervisionError` and the child is torn
  down. The dead sidecar's engine is dropped (and the card's cache
  emptied) before the replacement is built, so a restart never needs two
  models' memory. The child gateway finds the new sidecar through gRPC's
  channel reconnect and its own discovery watchdog
  (`grpc.reconnect.watchdog_interval_s`): the reference nudges its
  in-process discoverer instead, which this layout cannot reach.
- The child: the gateway's config sections (`Config.sections`) in a
  private temp JSON file (`serving` stripped: port-only keys would fail
  the reference's checks), an environment without GGRMCP_SERVING_*,
  stdout and stderr to a log file (an undrained pipe wedges it), its own
  process group, and on Linux PR_SET_PDEATHSIG so that it never outlives
  this process. If it exits, the sidecar is stopped and
  `GatewayExitedError` carries its exit code and the tail of its log.
- The replica fleet (`fleet.enabled`): the child's supervisor spawns
  this port's worker (serving/fleet.py) in place of the reference's,
  through a stub that sets the worker command in the child's memory,
  and the workers take `serving`, the device and the seed from the
  child's environment. The co-launched sidecar stays a static backend
  outside the supervisor's pool, as in the reference. The workers share
  the child's process group, so ending the child ends them too.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import logging
import os
import random
import signal
import sys
import tempfile
from typing import Callable, Optional, Sequence

import torch

from ggrmcp_tpu_torch.core.config import Config, ServingConfig

logger = logging.getLogger("ggrmcp.torch.launcher")

# Runs the gateway under PR_SET_PDEATHSIG (1): the kernel sends it
# SIGTERM when this process dies, however it dies. It execs the real
# command (argv[2:]) after checking that its parent (argv[1]) is still
# the launcher, closing the race with a launcher that died first.
_PDEATHSIG_EXEC = (
    "import ctypes, os, signal, sys\n"
    "ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGTERM))\n"
    "if os.getppid() != int(sys.argv[1]):\n"
    "    sys.exit(1)\n"
    "os.execv(sys.executable, [sys.executable, *sys.argv[2:]])\n"
)

# The gateway of a co-launch with `fleet.enabled`: in the child's own
# memory, the reference's worker command (`default_worker_argv`, which
# its `ProcessReplicaFactory` looks up when the fleet starts and
# documents as the override for another worker) becomes this port's
# worker; then `python -m ggrmcp_tpu` runs with the same arguments. The
# gateway's pid goes into the environment its workers inherit, for their
# PR_SET_PDEATHSIG check (serving/fleet.py).
_FLEET_GATEWAY = (
    "import os, runpy, sys\n"
    "import ggrmcp_tpu.serving.fleet as fleet\n"
    "fleet.default_worker_argv = lambda: [\n"
    "    sys.executable, '-m', 'ggrmcp_tpu_torch.serving.fleet']\n"
    "os.environ['GGRMCP_FLEET_WORKER_TORCH_PARENT'] = str(os.getpid())\n"
    "sys.argv = ['ggrmcp_tpu', *sys.argv[1:]]\n"
    "runpy.run_module('ggrmcp_tpu', run_name='__main__', alter_sys=True)\n"
)

# Seconds a child gateway gets to exit on SIGTERM before SIGKILL.
_CHILD_TERM_GRACE_S = 10.0


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


class GatewayExitedError(RuntimeError):
    """The co-launched gateway process exited while the sidecar served."""

    def __init__(self, code: Optional[int], tail: str):
        super().__init__(
            f"co-launched gateway exited with code {code}; its log ends:\n"
            f"{tail}"
        )
        self.code = code


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


def gateway_environ(cfg: Optional[Config] = None, device=None,
                    seed: int = 0) -> dict:
    """The child's environment: ours without GGRMCP_SERVING_* (port-only
    serving keys would fail the reference's checks), with the repository
    root on PYTHONPATH so that `-m ggrmcp_tpu` resolves wherever we were
    started. With `cfg.fleet.enabled`, the fleet workers' handshake
    (serving/fleet.py): `cfg.serving`, `device` and `seed`, which every
    worker inherits from the child, so replicas serve what the co-launched
    sidecar serves."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GGRMCP_SERVING_")}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    if cfg is not None and cfg.fleet.enabled:
        from ggrmcp_tpu_torch.serving.fleet import handshake_environ

        env.update(handshake_environ(cfg.serving, device, seed))
    return env


def gateway_command(targets: Sequence[str], config_path: str,
                    flags: Sequence[str] = (),
                    fleet: bool = False) -> list[str]:
    """`python -m ggrmcp_tpu gateway` over `targets` (the sidecar first),
    reading `config_path`, with the caller's gateway flags (with `fleet`,
    through the stub that makes its fleet spawn this port's workers); on
    Linux behind the PR_SET_PDEATHSIG exec stub."""
    cmd = ["-c", _FLEET_GATEWAY] if fleet else ["-m", "ggrmcp_tpu"]
    cmd += ["gateway", "--config", config_path]
    for target in targets:
        cmd += ["--backend", target]
    cmd += list(flags)
    if sys.platform.startswith("linux"):
        return [sys.executable, "-c", _PDEATHSIG_EXEC, str(os.getpid()),
                *cmd]
    return [sys.executable, *cmd]


def free_device_memory() -> None:
    """Collect a dropped engine's tensors and return the card's cached
    blocks, so that a replacement can take the same memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Colaunch:
    """The sidecar (built by `sidecar_factory`, default the port's
    Sidecar over `cfg.serving` on `device`, after
    `resolve_colaunch_transport`) and the gateway child over it plus
    `extra_targets` (external backends that were given explicitly),
    started with `gateway_flags` (e.g. ["--http-port", "55053"]).
    `start()`, then `wait()` (raises when the sidecar is given up or the
    child exits), and always `stop()`."""

    def __init__(
        self,
        cfg: Config,
        gateway_flags: Sequence[str] = (),
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
        self._flags = list(gateway_flags)
        self._extra = list(extra_targets)
        self.sidecar = None
        self.child: Optional[asyncio.subprocess.Process] = None
        self.restarts = 0
        self._config_path = ""
        self._log = None
        self._supervisor: Optional[asyncio.Task] = None
        self._child_exit: Optional[asyncio.Task] = None

    @property
    def target(self) -> str:
        return self.sidecar.target if self.sidecar is not None else ""

    async def start(self) -> None:
        self.sidecar = self._factory()
        await self.sidecar.start()
        targets = [self.sidecar.target]
        targets += [t for t in self._extra if t not in targets]
        fd, self._config_path = tempfile.mkstemp(
            prefix="ggrmcp-gateway-", suffix=".json")
        with os.fdopen(fd, "w") as fh:  # mkstemp: mode 0600
            json.dump(self.cfg.sections, fh)
        self._log = tempfile.NamedTemporaryFile(
            prefix="ggrmcp-gateway-", suffix=".log", delete=False)
        self.child = await asyncio.create_subprocess_exec(
            *gateway_command(targets, self._config_path, self._flags,
                             self.cfg.fleet.enabled),
            stdin=asyncio.subprocess.DEVNULL, stdout=self._log,
            stderr=asyncio.subprocess.STDOUT,
            env=gateway_environ(self.cfg, self._device, self._seed),
            start_new_session=True,
        )
        logger.info(
            "co-launched sidecar on %s; gateway pid %d over %s (log %s)",
            self.sidecar.target, self.child.pid, targets, self._log.name,
        )
        loop = asyncio.get_running_loop()
        self._supervisor = loop.create_task(self._supervise())
        self._child_exit = loop.create_task(self.child.wait())

    async def wait(self) -> None:
        """Until the sidecar is given up (SidecarSupervisionError) or the
        child exits (GatewayExitedError); never returns normally."""
        await asyncio.wait({self._supervisor, self._child_exit},
                           return_when=asyncio.FIRST_COMPLETED)
        if self._supervisor.done():
            self._supervisor.result()
        raise GatewayExitedError(self._child_exit.result(), self.log_tail())

    def log_tail(self, limit: int = 4000) -> str:
        if self._log is None or self._log.closed:
            return ""
        with open(self._log.name, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - limit))
            return fh.read().decode(errors="replace")

    async def _supervise(self) -> None:
        """Restart the sidecar with backoff when it dies. Runs until
        cancelled (stop() cancels it BEFORE stopping the sidecar, so a
        deliberate stop is never mistaken for a death)."""
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
                    self.restarts += 1
                    logger.warning(
                        "co-launched sidecar restarted on %s (attempt "
                        "%d/%d)", replacement.target, attempt + 1,
                        fleet.restart_max_attempts,
                    )
                    break
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 — retried, typed below
                    last_error = str(exc)
                    logger.error(
                        "sidecar restart attempt %d/%d failed: %s",
                        attempt + 1, fleet.restart_max_attempts, exc,
                    )
            else:
                raise SidecarSupervisionError(
                    fleet.restart_max_attempts, last_error)

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
        """Cancel supervision, stop the sidecar (its socket file goes)
        and release it, end the child and remove the child's config
        file."""
        for task in (self._supervisor, self._child_exit):
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        await self._drop_sidecar(dead=False)
        await self._end_child()
        if self._config_path:
            try:
                os.unlink(self._config_path)
            except FileNotFoundError:
                pass
        if self._log is not None:
            self._log.close()
            os.unlink(self._log.name)

    async def _end_child(self) -> None:
        child = self.child
        if child is None or child.returncode is not None:
            return
        for sig, grace in ((signal.SIGTERM, _CHILD_TERM_GRACE_S),
                           (signal.SIGKILL, None)):
            try:
                os.killpg(child.pid, sig)
            except ProcessLookupError:
                break
            try:
                await asyncio.wait_for(child.wait(), grace)
                break
            except asyncio.TimeoutError:
                continue


async def run_colaunch(colaunch: Colaunch, stop: asyncio.Event) -> None:
    """Start `colaunch` and serve until `stop` is set (returns) or the
    co-launch fails (raises); it is stopped either way."""
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
