"""The replica worker of the gateway's fleet: `python -m
ggrmcp_tpu_torch.serving.fleet`.

Counterpart of the worker half of `ggrmcp_tpu/serving/fleet.py`
(`_worker_main`). The supervisor, its metrics and `/admin/fleet` are
gateway-plane code and run unchanged in the gateway child that the
co-launch starts (serving/launcher.py); that child's stub names this
module as the worker command, the override its `ProcessReplicaFactory`
documents. A worker starts the port's `Sidecar` on an ephemeral port,
prints `TARGET=<target>` once it serves, and serves until it is killed.

Its settings, in order:
- the reference's spawn knobs, GGRMCP_FLEET_WORKER_{MODEL, ROLE, SLOTS,
  MAXSEQ, PENDING, PAGED, PAGES}, with the reference's defaults
  (tiny-llama, mixed, 4 slots, 512 positions, one decode step a tick, 8
  pending, paged off, 192 pages when paged is on): a worker spawned by a
  plain gateway serves what the reference's worker serves;
- the co-launch's handshake, which goes over the knobs: the port's whole
  `serving` section as JSON in GGRMCP_FLEET_WORKER_TORCH_SERVING (the
  gateway stamps the knobs from its own serving section, which the
  launcher strips, so they would name the reference's defaults), the
  device in GGRMCP_FLEET_WORKER_TORCH_DEVICE and the weights' seed in
  GGRMCP_FLEET_WORKER_TORCH_SEED. The GGRMCP_FLEET_WORKER_ prefix is the
  one both packages' environment layers skip.

Without a device the worker asks for the card and raises when there is
none; it never serves on the CPU unless told to. GGRMCP_FAILPOINTS arms
`replica_crash` and `health_flap` in the worker as in any sidecar of the
port (utils/failpoints.py reads it at import). On Linux the worker sets
PR_SET_PDEATHSIG, so that the kernel kills it when the gateway that
spawned it dies: a worker holds a model's weights on the card.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import signal
import sys
from typing import Mapping, Optional

from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    ServingConfig,
    config_from_dict,
)

# The handshake: the co-launch's serving section, device and seed.
ENV_SERVING = "GGRMCP_FLEET_WORKER_TORCH_SERVING"
ENV_DEVICE = "GGRMCP_FLEET_WORKER_TORCH_DEVICE"
ENV_SEED = "GGRMCP_FLEET_WORKER_TORCH_SEED"
# The gateway's pid, set by the co-launch's gateway stub: a worker whose
# parent is no longer that process was orphaned before it could arm
# PR_SET_PDEATHSIG.
ENV_PARENT = "GGRMCP_FLEET_WORKER_TORCH_PARENT"


def worker_serving_config(env: Mapping[str, str]) -> ServingConfig:
    """The worker's serving settings from `env`: the handshake's section
    when present (its socket and port cleared: a worker takes an
    ephemeral TCP port), else the reference worker's knobs and
    defaults."""
    section = env.get(ENV_SERVING)
    if section:
        serving = config_from_dict({"serving": json.loads(section)}).serving
        return dataclasses.replace(serving, uds_path="", port=0)
    paged = env.get("GGRMCP_FLEET_WORKER_PAGED", "off")
    return ServingConfig(
        model=env.get("GGRMCP_FLEET_WORKER_MODEL", "tiny-llama"),
        role=env.get("GGRMCP_FLEET_WORKER_ROLE", "mixed"),
        batching=BatchingConfig(
            max_batch_size=int(env.get("GGRMCP_FLEET_WORKER_SLOTS", "4")),
            kv_cache_max_seq=int(
                env.get("GGRMCP_FLEET_WORKER_MAXSEQ", "512")),
            decode_steps_per_tick=1,
            max_pending=int(env.get("GGRMCP_FLEET_WORKER_PENDING", "8")),
            paged_kv=paged,
            **({"paged_kv_pages": int(
                env.get("GGRMCP_FLEET_WORKER_PAGES", "192"))}
               if paged == "on" else {}),
        ),
    )


def handshake_environ(serving: ServingConfig, device=None,
                      seed: int = 0) -> dict:
    """The handshake variables that make a worker serve `serving` on
    `device` (None: the card) with weights from `seed`."""
    env = {ENV_SERVING: json.dumps(dataclasses.asdict(serving)),
           ENV_SEED: str(seed)}
    if device is not None:
        env[ENV_DEVICE] = str(device)
    return env


def _die_with_parent(env: Mapping[str, str]) -> None:
    """PR_SET_PDEATHSIG (1) with SIGKILL, then exit if the parent the
    stub named is already gone (the race the launcher's stub closes the
    same way)."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    parent = env.get(ENV_PARENT)
    if parent and os.getppid() != int(parent):
        sys.exit(1)


async def _worker_main(env: Optional[Mapping[str, str]] = None) -> None:
    """One replica: start on an ephemeral port, print TARGET=<target>,
    serve until killed."""
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    env = os.environ if env is None else env
    _die_with_parent(env)
    serving = worker_serving_config(env)
    sidecar = Sidecar(serving, seed=int(env.get(ENV_SEED, "0")),
                      device=env.get(ENV_DEVICE) or None)
    await sidecar.start(0)
    print(f"TARGET={sidecar.target}", flush=True)
    await asyncio.Event().wait()  # the supervisor kills the process


def main() -> None:
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    asyncio.run(_worker_main())


if __name__ == "__main__":
    main()
