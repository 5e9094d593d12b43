"""Service discovery orchestration and the tool registry/router.

Capability parity with the reference discoverer (pkg/grpc/discovery.go):
owns connection + reflection + descriptor-set loading, holds the
toolName → MethodInfo registry as an immutable dict swapped atomically
on rediscovery (the Python analogue of the reference's atomic.Pointer,
discovery.go:21), routes tool invocations, reports stats and health.

Extended beyond the reference: multiple backends — each backend is an
`Endpoint` (one gRPC target, e.g. one TPU serving sidecar); tools from
all backends merge into one registry, and invocation routes to the
owning backend. Streaming methods are registered when the gateway's
streaming path is enabled instead of being rejected outright.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Optional

import grpc
import grpc.aio

from ggrmcp_tpu_torch.core.config import GRPCConfig, RoutingConfig
from ggrmcp_tpu_torch.core.types import MethodInfo
from ggrmcp_tpu_torch.rpc.connection import ChannelManager
from ggrmcp_tpu_torch.rpc.descriptors import CommentIndex, DescriptorSetLoader
from ggrmcp_tpu_torch.rpc.reflection_client import DynamicInvoker, ReflectionClient
from ggrmcp_tpu_torch.rpc.router import (
    ReplicaRouter,
    derive_affinity_key,
    estimate_prefill_tokens,
)
from ggrmcp_tpu_torch.utils import failpoints, tracing

logger = logging.getLogger("ggrmcp.rpc.discovery")


class ToolNotFoundError(KeyError):
    pass


class StreamingNotSupportedError(RuntimeError):
    pass


class Backend:
    """One upstream gRPC target: channel + reflection + invoker."""

    def __init__(self, name: str, target: str, cfg: GRPCConfig):
        self.name = name
        self.target = target
        self.cfg = cfg
        self.manager = ChannelManager(target, cfg)
        self.reflection: Optional[ReflectionClient] = None
        self.invoker: Optional[DynamicInvoker] = None
        self.methods: list[MethodInfo] = []
        self.comments = CommentIndex()
        self.healthy = False
        # Graceful drain (POST /admin/drain): a draining backend takes
        # no NEW placements — in-flight calls finish, rediscovery keeps
        # its tools resolvable via the remaining replicas, un-drain
        # restores it to the candidate set.
        self.draining = False
        # Declared serving role ("mixed" | "prefill" | "decode"),
        # stamped by discover_services from the backend's ServingStats
        # — static per replica process, refreshed on rediscovery (a
        # role flip is drain → restart → rediscover). The router reads
        # this attribute on the hot path; plain gRPC upstreams and
        # pre-role sidecars stay "mixed".
        self.role = "mixed"
        self.last_discovery: float = 0.0

    async def connect(self, timeout_s: Optional[float] = None) -> None:
        """Dial + build reflection client + deep health check
        (discovery.go:65-88 parity)."""
        channel = await self.manager.connect(timeout_s)
        self.reflection = ReflectionClient(channel)
        self.invoker = DynamicInvoker(channel)
        self.healthy = await self.reflection.health_check()
        if not self.healthy:
            raise ConnectionError(
                f"backend {self.target}: reflection health check failed"
            )

    async def discover(self) -> list[MethodInfo]:
        """Reflection discovery; descriptor-set discovery happens at the
        discoverer level since it needs no connection."""
        if self.reflection is None:
            raise ConnectionError(f"backend {self.target} not connected")
        methods, comments = await self.reflection.discover_methods()
        if self.invoker is not None:
            # New discovery pass may carry a fresh descriptor pool;
            # stale cache entries would pin the old one forever.
            self.invoker.invalidate_cache()
        self.methods = methods
        self.comments = comments
        self.last_discovery = time.time()
        return methods

    async def health_check(self) -> bool:
        if self.reflection is None:
            return False
        conn_ok = await self.manager.health_check()
        if not conn_ok:
            self.healthy = False
            return False
        self.healthy = await self.reflection.health_check()
        return self.healthy

    async def close(self) -> None:
        await self.manager.close()


class ServiceDiscoverer:
    """Discovers tools across backends and routes invocations."""

    def __init__(
        self,
        targets: list[str] | str,
        cfg: Optional[GRPCConfig] = None,
        allow_streaming_tools: bool = True,
        routing: Optional[RoutingConfig] = None,
    ):
        self.cfg = cfg or GRPCConfig()
        if isinstance(targets, str):
            targets = [targets]
        self.backends = [
            Backend(f"backend{i}", target, self.cfg)
            for i, target in enumerate(targets)
        ]
        self.allow_streaming_tools = allow_streaming_tools
        # tool name → (MethodInfo, [replica backends]). Immutable dict,
        # swapped whole on rediscovery — lock-free reads under the GIL,
        # the Python analogue of atomic.Pointer (discovery.go:21,
        # 122-127). Multiple backends serving the SAME method full name
        # are DP replicas: the router places each call over the healthy,
        # non-draining ones (rpc/router.py; round-robin by default).
        self._tools: dict[str, tuple[MethodInfo, list[Backend]]] = {}
        # Placement policy (gateway.routing): reads the serving-stats
        # snapshot below, never a live fan-out.
        self.router = ReplicaRouter(routing, stats_view=self._stats_view)
        self._watchdog_task: Optional[asyncio.Task] = None
        # ServingStats snapshot for /metrics: a Prometheus scrape must
        # not block on a live gRPC fan-out (a wedged sidecar would add
        # its whole timeout to every scrape), so scrapes read this and
        # trigger a background refresh when stale.
        self._serving_stats_cache: list[dict[str, Any]] = []
        self._serving_stats_at = 0.0  # time.monotonic of last refresh
        self._serving_stats_task: Optional[asyncio.Task] = None

    # -- lifecycle ----------------------------------------------------------

    async def connect(self, timeout_s: Optional[float] = None) -> int:
        """Connect all backends; tolerate partial failure, raise if none."""
        results = await asyncio.gather(
            *(b.connect(timeout_s) for b in self.backends), return_exceptions=True
        )
        up = sum(1 for r in results if not isinstance(r, BaseException))
        for backend, result in zip(self.backends, results):
            if isinstance(result, BaseException):
                logger.warning("backend %s connect failed: %s", backend.target, result)
        if up == 0 and self.backends:
            raise ConnectionError("no backends reachable")
        return up

    async def discover_services(self) -> int:
        """(Re)build the tool registry (discovery.go:91-129). If a
        descriptor set is configured it is loaded first (richer
        comments); reflection fills in the rest, keyed per backend."""
        registry: dict[str, tuple[MethodInfo, Optional[Backend]]] = {}

        fds_methods: dict[str, MethodInfo] = {}
        if self.cfg.descriptor_set.enabled and self.cfg.descriptor_set.path:
            try:
                loader = DescriptorSetLoader(self.cfg.descriptor_set.path).load()
                for mi in loader.extract_method_info():
                    if not self._tool_allowed(mi):
                        continue
                    if mi.tool_name in fds_methods:
                        logger.warning(
                            "tool name collision in descriptor set: %s "
                            "(%s shadows %s)",
                            mi.tool_name, mi.full_name,
                            fds_methods[mi.tool_name].full_name,
                        )
                    fds_methods[mi.tool_name] = mi
                logger.info(
                    "descriptor set: %d methods from %s",
                    len(fds_methods), self.cfg.descriptor_set.path,
                )
            except Exception as exc:
                logger.warning(
                    "descriptor set load failed (%s); falling back to reflection",
                    exc,
                )

        for backend in self.backends:
            if backend.reflection is None:
                continue
            try:
                methods = await backend.discover()
            except asyncio.CancelledError:
                raise  # a cancelled rebuild must not half-populate
            except Exception as exc:
                logger.warning("discovery failed for %s: %s", backend.target, exc)
                continue
            for mi in methods:
                if not self._tool_allowed(mi):
                    continue
                fds_mi = fds_methods.get(mi.tool_name)
                if fds_mi is not None:
                    # Metadata merge: with prefer_over_reflection the
                    # FDS text (richer protoc comments) wins; otherwise
                    # FDS only fills gaps reflection left empty. Live
                    # descriptors always come from the backend.
                    if self.cfg.descriptor_set.prefer_over_reflection:
                        mi.description = fds_mi.description or mi.description
                        mi.service_description = (
                            fds_mi.service_description or mi.service_description
                        )
                    else:
                        mi.description = mi.description or fds_mi.description
                        mi.service_description = (
                            mi.service_description or fds_mi.service_description
                        )
                existing = registry.get(mi.tool_name)
                if existing is None:
                    registry[mi.tool_name] = (mi, [backend])
                elif existing[0].full_name == mi.full_name:
                    # Same method on another backend → DP replica.
                    existing[1].append(backend)
                else:
                    logger.warning(
                        "tool name collision across backends: %s (%s on %s "
                        "shadows %s)",
                        mi.tool_name, mi.full_name, backend.target,
                        existing[0].full_name,
                    )
                    registry[mi.tool_name] = (mi, [backend])

        # Descriptor-set-only methods (no live backend yet) are exposed
        # for listing and routed across all backends on call.
        for tool_name, mi in fds_methods.items():
            if tool_name not in registry:
                registry[tool_name] = (mi, list(self.backends))

        self._tools = registry  # atomic swap
        logger.info("tool registry: %d tools", len(registry))
        await self._refresh_roles()
        return len(registry)

    async def _refresh_roles(self) -> None:
        """Stamp each backend's declared serving role (serving.role,
        via its ServingStats RPC) — once per discovery pass, never on
        the call path. A backend without the RPC, or whose stats call
        fails, stays/reverts to "mixed": degrading a prefill replica to
        mixed serves it ordinary traffic (safe — every replica can),
        whereas acting on a stale role could starve it."""
        for backend in self.backends:
            mi = next(
                (
                    m for m in backend.methods
                    if m.full_name == self.SERVING_STATS_METHOD
                ),
                None,
            )
            if mi is None or backend.invoker is None:
                backend.role = "mixed"
                continue
            try:
                out = await backend.invoker.invoke(mi, {}, None, 2.0)
                role = out.get("role") or "mixed"
            except asyncio.CancelledError:
                raise  # a cancelled rebuild must not half-stamp
            except Exception as exc:  # noqa: BLE001 — degrade to mixed
                logger.warning(
                    "role probe failed for %s (treating as mixed): %s",
                    backend.target, exc,
                )
                role = "mixed"
            if role != backend.role:
                logger.info(
                    "backend %s serving role: %s", backend.target, role
                )
            backend.role = role

    def _tool_allowed(self, mi: MethodInfo) -> bool:
        """Streaming gating applied uniformly to reflection- and
        FDS-discovered methods: client streaming is never servable;
        server streaming only when enabled."""
        if mi.is_client_streaming:
            return False
        if mi.is_server_streaming and not self.allow_streaming_tools:
            return False
        return True

    async def close(self) -> None:
        await self.stop_watchdog()
        if self._serving_stats_task is not None:
            # an in-flight snapshot refresh must not outlive the
            # backends it fans out to
            self._serving_stats_task.cancel()
            try:
                await self._serving_stats_task
            except asyncio.CancelledError:
                # Expected when it is the TASK's cancellation (ours,
                # one line up). If the task did NOT end cancelled, the
                # CancelledError was aimed at close() itself — swallow
                # it and a cancelled shutdown wedges half-closed.
                if not self._serving_stats_task.cancelled():
                    raise
            except Exception:  # noqa: BLE001 — refresh errors only
                pass
            self._serving_stats_task = None
        await asyncio.gather(
            *(b.close() for b in self.backends), return_exceptions=True
        )

    # -- background watchdog (fixes the reference's dead Reconnect) --------

    def start_watchdog(self) -> None:
        if self._watchdog_task is None:
            self._watchdog_task = asyncio.get_running_loop().create_task(
                self._watchdog()
            )

    async def stop_watchdog(self) -> None:
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except asyncio.CancelledError:
                pass
            self._watchdog_task = None

    async def _watchdog(self) -> None:
        interval = self.cfg.reconnect.watchdog_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                changed = False
                for backend in self.backends:
                    was = backend.healthy
                    ok = await backend.health_check()
                    if not ok and self.cfg.reconnect.enabled:
                        ok = await self._try_reconnect(backend)
                    if ok and not was:
                        changed = True
                if changed:
                    await self.discover_services()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("discovery watchdog pass failed")

    async def _try_reconnect(self, backend: Backend) -> bool:
        for attempt in range(self.cfg.reconnect.max_attempts):
            try:
                # Chaos hook (utils/failpoints.py): an injected fault
                # here is a dial that failed — it burns an attempt and
                # takes the same backoff as a real connect error.
                failpoints.evaluate("reconnect_fail")
                await backend.connect()
                return True
            except asyncio.CancelledError:
                raise  # cancellation outranks the retry budget
            except Exception as exc:
                logger.warning(
                    "reconnect %s attempt %d/%d failed: %s",
                    backend.target, attempt + 1,
                    self.cfg.reconnect.max_attempts, exc,
                )
                await asyncio.sleep(self.cfg.reconnect.interval_s)
        return False

    # -- registry access ----------------------------------------------------

    def get_methods(self) -> list[MethodInfo]:
        return [mi for mi, _ in self._tools.values()]

    def get_method_by_tool(self, tool_name: str) -> MethodInfo:
        entry = self._tools.get(tool_name)
        if entry is None:
            raise ToolNotFoundError(f"tool not found: {tool_name}")
        return entry[0]

    def comment_fn(self, desc) -> str:
        """Merged comment provider across all backends, for the schema
        builder."""
        for backend in self.backends:
            comment = backend.comments.comment_fn(desc)
            if comment:
                return comment
        return ""

    # -- invocation ---------------------------------------------------------

    def _candidates(
        self, tool_name: str
    ) -> tuple[MethodInfo, list[Backend]]:
        """Pick-time membership filtering: unhealthy backends are
        skipped (a dead replica must not keep eating every k-th call
        until rediscovery), draining backends take no new placements —
        falling back to any connected non-draining backend only when
        none is healthy. Shared by single-leg routing and the
        disaggregated two-leg plan."""
        entry = self._tools.get(tool_name)
        if entry is None:
            raise ToolNotFoundError(f"tool not found: {tool_name}")
        method, backends = entry
        live = [b for b in backends if b.invoker is not None]
        if not live:
            raise ConnectionError(f"no live backend for tool {tool_name}")
        placeable = [b for b in live if not b.draining]
        if not placeable:
            # Draining the LAST replica of a tool leaves nowhere to
            # place — surface the operational state, don't fabricate a
            # placement that violates the drain contract.
            raise ConnectionError(
                f"all replicas draining for tool {tool_name}"
            )
        for b in live:
            if b.draining:
                self.router.note_drain_reject(b.target)
        return method, ([b for b in placeable if b.healthy] or placeable)

    def _route(
        self,
        tool_name: str,
        arguments: Optional[dict[str, Any]] = None,
        headers: Optional[list[tuple[str, str]]] = None,
    ) -> tuple[MethodInfo, Backend]:
        """Pick the serving replica (per-shard routing from the north
        star; DP replicas share a tool name). The router
        (gateway.routing.policy) places over the filtered candidates
        (_candidates)."""
        method, candidates = self._candidates(tool_name)
        affinity_key = None
        if self.router.wants_affinity_key and arguments is not None:
            affinity_key = derive_affinity_key(
                tool_name, arguments, headers,
                self.router.cfg.affinity_preamble_bytes,
            )
        est_tokens = 0
        if self.router.wants_prefill_estimate and arguments is not None:
            est_tokens = estimate_prefill_tokens(arguments)
        if self.router.policy != "round_robin":
            # Score-based policies read the snapshot; keep it warm the
            # same way /metrics does — a background refresh, never an
            # awaited fan-out on the call path.
            self._maybe_refresh_serving_stats()
        backend = self.router.pick(
            tool_name, candidates,
            affinity_key=affinity_key, est_prefill_tokens=est_tokens,
        )
        return method, backend

    def _check_backend_down(self, backend: Backend) -> None:
        """Chaos hook (utils/failpoints.py `backend_down`): an injected
        fault here IS a replica dying out from under a routed call —
        the call fails with the same typed error a dead channel raises
        and the backend drops out of the candidate set until the
        watchdog revives it. Every placement passes here: the call's
        span (the gateway's `gateway.invoke`) gets its target."""
        span = tracing.tracer.current()
        if span is not None:
            span.set(target=backend.target)
        try:
            failpoints.evaluate("backend_down")
        except failpoints.FailpointError as exc:
            backend.healthy = False
            raise ConnectionError(
                f"backend {backend.target} went down (injected): {exc}"
            ) from exc

    # -- disaggregated prefill/decode placement (serving.role) --------------

    # Only the TPU generate surface is disaggregation-eligible: the
    # two-leg plan injects GenerateRequest.kv_transfer_target, which no
    # other discovered method carries.
    GENERATE_SERVICE_PREFIX = "ggrmcp.tpu.GenerateService."

    def _plan_disagg(
        self,
        tool_name: str,
        arguments: Optional[dict[str, Any]],
        headers: Optional[list[tuple[str, str]]],
    ) -> Optional[tuple[MethodInfo, Backend, Backend]]:
        """(method, prefill replica, decode replica) when this call
        should take the two-leg prefill→TransferKV→decode path, else
        None. Cheap on the common paths by construction: pure-mixed
        fleets bail on the role-attribute scan and non-generate tools
        on the name prefix — a roleless deployment never pays for a
        prefill estimate or a plan (and routes bit-for-bit as
        before)."""
        if self.router.cfg.disagg == "off" or not isinstance(
            arguments, dict
        ):
            return None
        if all(b.role == "mixed" for b in self.backends):
            return None
        entry = self._tools.get(tool_name)
        if entry is None or not entry[0].full_name.startswith(
            self.GENERATE_SERVICE_PREFIX
        ):
            return None
        # Adapter'd calls disaggregate too: page chains
        # are keyed per adapter domain (serving/pages.py adapter_root),
        # the prefill leg runs under the request's adapter, and the
        # TransferKV chunk carries the adapter name so the decode
        # replica re-derives the same chain — the old "adapter'd KV
        # never enters shared storage" skip is lifted.
        method, candidates = self._candidates(tool_name)
        if len(candidates) < 2:
            return None
        affinity_key = None
        if self.router.wants_affinity_key:
            affinity_key = derive_affinity_key(
                tool_name, arguments, headers,
                self.router.cfg.affinity_preamble_bytes,
            )
        plan = self.router.plan_disagg(
            tool_name, candidates,
            estimate_prefill_tokens(arguments),
            affinity_key=affinity_key,
        )
        if plan is None:
            return None
        return method, plan[0], plan[1]

    async def _prefill_leg(
        self,
        method: MethodInfo,
        prefill: Backend,
        decode: Backend,
        arguments: dict[str, Any],
        headers: Optional[list[tuple[str, str]]],
        timeout: float,
    ) -> bool:
        """Run the prefill leg: the same request with
        kvTransferTarget=<decode replica> — the prefill sidecar
        prefills, ships the prompt's KV pages to the decode sidecar,
        and answers "transferred". Returns False on a TYPED transfer
        failure (gRPC ABORTED / FAILED_PRECONDITION /
        RESOURCE_EXHAUSTED, or the backend dying under the call): the
        caller then retries the WHOLE request on a mixed replica —
        loud, counted, bit-identical. Anything untyped propagates."""
        prefill_args = dict(arguments)
        prefill_args["kvTransferTarget"] = decode.target
        try:
            self._check_backend_down(prefill)
            if method.is_server_streaming:
                async for _chunk in prefill.invoker.invoke_stream(
                    method, prefill_args, headers, timeout
                ):
                    pass  # exactly one terminal "transferred" chunk
            else:
                await prefill.invoker.invoke(
                    method, prefill_args, headers, timeout
                )
            return True
        except asyncio.CancelledError:
            raise  # the caller is gone; no fallback owed
        except ConnectionError as exc:
            # backend_down chaos / dead channel: the prefill replica
            # died under the leg — same typed retry as a failed ship.
            logger.warning(
                "disagg prefill leg on %s failed (%s); retrying on a "
                "mixed replica", prefill.target, exc,
            )
            return False
        except grpc.aio.AioRpcError as exc:
            if exc.code() in (
                grpc.StatusCode.ABORTED,
                grpc.StatusCode.FAILED_PRECONDITION,
                grpc.StatusCode.RESOURCE_EXHAUSTED,
            ):
                logger.warning(
                    "disagg prefill leg on %s failed typed (%s: %s); "
                    "retrying on a mixed replica",
                    prefill.target, exc.code().name, exc.details(),
                )
                return False
            raise

    async def invoke_by_tool(
        self,
        tool_name: str,
        arguments: dict[str, Any],
        headers: Optional[list[tuple[str, str]]] = None,
        timeout_s: Optional[float] = None,
    ) -> dict[str, Any]:
        """Route a unary tool call (discovery.go:346-375 parity).
        Long-prompt calls in a role-split fleet take the two-leg
        disaggregated path (_plan_disagg); everything else routes as
        before."""
        timeout = timeout_s if timeout_s is not None else self.cfg.call_timeout_s
        plan = self._plan_disagg(tool_name, arguments, headers)
        if plan is not None:
            method, prefill, decode = plan
            if method.is_streaming:
                raise StreamingNotSupportedError(
                    f"tool {tool_name} is streaming; use "
                    f"invoke_stream_by_tool"
                )
            if await self._prefill_leg(
                method, prefill, decode, arguments, headers, timeout
            ):
                self._check_backend_down(decode)
                return await decode.invoker.invoke(
                    method, arguments, headers, timeout
                )
            _, candidates = self._candidates(tool_name)
            backend = self.router.pick_fallback(tool_name, candidates)
            self._check_backend_down(backend)
            return await backend.invoker.invoke(
                method, arguments, headers, timeout
            )
        method, backend = self._route(tool_name, arguments, headers)
        if method.is_streaming:
            raise StreamingNotSupportedError(
                f"tool {tool_name} is streaming; use invoke_stream_by_tool"
            )
        self._check_backend_down(backend)
        return await backend.invoker.invoke(method, arguments, headers, timeout)

    async def invoke_stream_by_tool(
        self,
        tool_name: str,
        arguments: dict[str, Any],
        headers: Optional[list[tuple[str, str]]] = None,
        timeout_s: Optional[float] = None,
    ) -> AsyncIterator[dict[str, Any]]:
        """Route a server-streaming tool call (no reference analogue).
        Disaggregation applies here too: the prefill leg is consumed
        silently (one "transferred" chunk), then the decode replica's
        stream is the caller's stream."""
        timeout = timeout_s if timeout_s is not None else self.cfg.call_timeout_s
        plan = self._plan_disagg(tool_name, arguments, headers)
        if plan is not None:
            method, prefill, decode = plan
            if method.is_client_streaming:
                raise StreamingNotSupportedError(
                    "client streaming not supported"
                )
            if await self._prefill_leg(
                method, prefill, decode, arguments, headers, timeout
            ):
                backend = decode
            else:
                _, candidates = self._candidates(tool_name)
                backend = self.router.pick_fallback(tool_name, candidates)
        else:
            method, backend = self._route(tool_name, arguments, headers)
            if method.is_client_streaming:
                raise StreamingNotSupportedError(
                    "client streaming not supported"
                )
        self._check_backend_down(backend)
        if not method.is_server_streaming:
            yield await backend.invoker.invoke(method, arguments, headers, timeout)
            return
        async for chunk in backend.invoker.invoke_stream(
            method, arguments, headers, timeout
        ):
            yield chunk

    # -- elastic membership (the fleet supervisor's add/remove plane) --------

    async def add_backend(self, target: str) -> Backend:
        """Register + connect a NEW backend at runtime and rebuild the
        tool registry so its methods join the replica pools — the
        spawn half of the fleet supervisor's act plane
        (serving/fleet.py). Idempotent per target: re-adding an
        existing target just returns it. Connection failures propagate
        (the caller owns the replica process and must know the spawn
        did not take) after the backend is removed again — a backend
        that never connected must not linger in the candidate set."""
        for backend in self.backends:
            if backend.target == target:
                return backend
        backend = Backend(f"backend{len(self.backends)}", target, self.cfg)
        self.backends.append(backend)
        try:
            await backend.connect(self.cfg.connect_timeout_s)
        except BaseException:
            self.backends.remove(backend)
            await backend.close()
            raise
        await self.discover_services()
        logger.info("backend %s added at runtime", target)
        return backend

    async def remove_backend(self, target: str) -> None:
        """Deregister a backend (by target or backendN name) and
        rebuild the registry without it — the retire/kill half of the
        fleet supervisor's act plane. Unknown targets are a no-op (the
        replica may have died before it ever connected). In-flight
        calls on the closed channel fail typed, exactly like a replica
        dying under a call — the chaos suite's zero-silent-loss contract
        covers both."""
        backend = next(
            (
                b for b in self.backends
                if target in (b.target, b.name)
            ),
            None,
        )
        if backend is None:
            return
        self.backends.remove(backend)
        await backend.close()
        await self.discover_services()
        logger.info("backend %s removed at runtime", target)

    # -- drain (the operational primitive behind POST /admin/drain) ---------

    def set_draining(self, target: str, draining: bool) -> list[dict[str, Any]]:
        """Mark one backend (by target, or by its backendN name)
        draining/undrained. Draining stops NEW placements only:
        in-flight calls finish untouched, the channel stays connected,
        rediscovery keeps the tools resolvable via the remaining
        replicas. Returns the per-backend state list; raises KeyError
        for an unknown backend."""
        for backend in self.backends:
            if target in (backend.target, backend.name):
                backend.draining = draining
                logger.warning(
                    "backend %s %s", backend.target,
                    "DRAINING (no new placements)" if draining
                    else "un-drained (restored to candidate set)",
                )
                break
        else:
            raise KeyError(target)
        return [
            {
                "target": b.target,
                "healthy": b.healthy,
                "draining": b.draining,
                "role": b.role,
            }
            for b in self.backends
        ]

    def get_routing_stats(self) -> dict[str, Any]:
        """Router policy + per-backend placement counters (/stats,
        /debug/requests, gateway_routing_* metrics)."""
        return self.router.snapshot()

    # -- health / stats -----------------------------------------------------

    SERVING_STATS_METHOD = "ggrmcp.tpu.ModelInfoService.GetServingStats"
    FLIGHT_RECORD_METHOD = "ggrmcp.tpu.DebugService.GetFlightRecord"
    MEMORY_METHOD = "ggrmcp.tpu.DebugService.GetMemory"
    PROFILE_METHOD = "ggrmcp.tpu.DebugService.Profile"

    async def _fanout_diagnostics(
        self,
        method_full_name: str,
        arguments: dict[str, Any],
        timeout_s: float,
    ) -> list[dict[str, Any]]:
        """Call a diagnostic RPC on every healthy backend that exposes
        it (TPU sidecars; other backends just don't have the method),
        one protojson entry per backend. Concurrent; a slow or failed
        backend contributes an {"target", "error"} entry, never an
        exception — a wedged sidecar must not fail the whole surface."""

        async def call(backend: Backend, mi) -> dict[str, Any]:
            try:
                out = await backend.invoker.invoke(
                    mi, arguments, None, timeout_s
                )
                return {"target": backend.target, **out}
            except asyncio.CancelledError:
                raise  # the gather owns cancellation, not the entry
            except Exception as exc:  # noqa: BLE001 — diagnostics only
                return {"target": backend.target, "error": str(exc)}

        jobs = []
        for backend in self.backends:
            if not backend.healthy or backend.invoker is None:
                continue
            mi = next(
                (
                    m for m in backend.methods
                    if m.full_name == method_full_name
                ),
                None,
            )
            if mi is not None:
                jobs.append(call(backend, mi))
        return list(await asyncio.gather(*jobs)) if jobs else []

    async def get_backend_flight_records(
        self,
        trace_id: str = "",
        max_ticks: int = 0,
        max_requests: int = 0,
        timeout_s: float = 2.0,
        tenant: str = "",
    ) -> list[dict[str, Any]]:
        """Flight-recorder rings from every healthy backend exposing
        DebugService.GetFlightRecord (TPU sidecars), one protojson
        entry per backend — the /debug/ticks and /debug/requests body.
        `tenant` filters request records to one tenant's lifecycle
        (server-side, like trace_id — the ring is scanned where it
        lives, not shipped whole)."""
        arguments: dict[str, Any] = {}
        if trace_id:
            arguments["traceId"] = trace_id
        if max_ticks:
            arguments["maxTicks"] = int(max_ticks)
        if max_requests:
            arguments["maxRequests"] = int(max_requests)
        if tenant:
            arguments["tenant"] = tenant
        return await self._fanout_diagnostics(
            self.FLIGHT_RECORD_METHOD, arguments, timeout_s
        )

    async def get_backend_serving_stats(
        self, timeout_s: float = 2.0
    ) -> list[dict[str, Any]]:
        """Best-effort ServingStats from every healthy backend exposing
        the model plane's stats RPC."""
        return await self._fanout_diagnostics(
            self.SERVING_STATS_METHOD, {}, timeout_s
        )

    async def get_backend_memory(
        self, reconcile: bool = True, timeout_s: float = 5.0
    ) -> list[dict[str, Any]]:
        """Device-memory ledger detail from every healthy backend
        exposing DebugService.GetMemory — the GET /debug/memory body
        (per-(scope, component) bytes, closure reconciliation against
        JAX live-buffer totals, compile watcher counters + ring)."""
        arguments: dict[str, Any] = (
            {"reconcile": True} if reconcile else {}
        )
        return await self._fanout_diagnostics(
            self.MEMORY_METHOD, arguments, timeout_s
        )

    async def profile_backends(
        self,
        duration_ms: int = 1000,
        label: str = "",
        timeout_s: float = 90.0,
    ) -> list[dict[str, Any]]:
        """Fan the sidecar DebugService.Profile capture out to every
        healthy backend — the POST /debug/profile body (per-backend
        server-side artifact paths). The timeout covers the capture
        window itself (the RPC blocks for duration_ms), with headroom
        for profiler start/stop."""
        arguments: dict[str, Any] = {}
        if duration_ms:
            arguments["durationMs"] = int(duration_ms)
        if label:
            arguments["outputDir"] = label
        return await self._fanout_diagnostics(
            self.PROFILE_METHOD, arguments,
            max(timeout_s, duration_ms / 1000.0 + 30.0),
        )

    def _stats_view(self) -> tuple[list[dict[str, Any]], float]:
        """The router's read-only view of the ServingStats snapshot:
        (entries, age in seconds). Never awaits anything."""
        if self._serving_stats_at == 0.0:
            return self._serving_stats_cache, float("inf")
        return (
            self._serving_stats_cache,
            time.monotonic() - self._serving_stats_at,
        )

    def _maybe_refresh_serving_stats(self, max_age_s: float = 5.0) -> bool:
        """Spawn the background snapshot refresh when the cache is
        older than max_age_s (and no refresh is already in flight).
        Shared by the Prometheus scrape path and the routing hot path —
        neither ever awaits the fan-out. Returns whether the snapshot
        was stale."""
        now = time.monotonic()
        stale = now - self._serving_stats_at >= max_age_s
        if stale and (
            self._serving_stats_task is None
            or self._serving_stats_task.done()
        ):
            async def refresh() -> None:
                try:
                    stats = await self.get_backend_serving_stats()
                    self._serving_stats_cache = stats
                except asyncio.CancelledError:
                    raise  # close() cancels this task; let it die clean
                except Exception as exc:  # noqa: BLE001
                    # Keep the stale snapshot but still stamp the time:
                    # a failing backend must back off for max_age_s, not
                    # respawn a doomed task (and leak its exception as
                    # "never retrieved") on every scrape.
                    logger.warning("serving-stats refresh failed: %s", exc)
                self._serving_stats_at = time.monotonic()

            self._serving_stats_task = asyncio.create_task(refresh())
        return stale

    async def get_serving_stats_snapshot(
        self, max_age_s: float = 5.0, first_wait_s: float = 0.5
    ) -> list[dict[str, Any]]:
        """Last-known ServingStats for the Prometheus scrape path:
        returns the cached snapshot immediately and refreshes it in the
        background when older than max_age_s, so scrape latency never
        couples to backend responsiveness. The very first scrape (no
        snapshot yet) waits up to first_wait_s for the refresh so a
        healthy stack doesn't export an empty first sample."""
        self._maybe_refresh_serving_stats(max_age_s)
        if self._serving_stats_at == 0.0 and self._serving_stats_task:
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._serving_stats_task), first_wait_s
                )
            except asyncio.CancelledError:
                raise  # the SCRAPE was cancelled (shield guards the task)
            except Exception:  # noqa: BLE001
                pass  # scrape must never fail on a slow backend
        return list(self._serving_stats_cache)

    async def health_check(self) -> bool:
        """Healthy iff at least one backend passes its deep check."""
        if not self.backends:
            return bool(self._tools)
        results = await asyncio.gather(
            *(b.health_check() for b in self.backends), return_exceptions=True
        )
        return any(r is True for r in results)

    def get_service_stats(self) -> dict[str, Any]:
        """Structured stats (discovery.go:279-333 parity, per-backend)."""
        services: dict[str, int] = {}
        streaming = 0
        for mi, _ in self._tools.values():
            services[mi.service_name] = services.get(mi.service_name, 0) + 1
            streaming += mi.is_streaming
        return {
            "serviceCount": len(services),
            "methodCount": len(self._tools),
            "streamingMethodCount": streaming,
            "isConnected": any(b.manager.is_connected() for b in self.backends),
            "services": [
                {"name": name, "methodCount": count}
                for name, count in sorted(services.items())
            ],
            "backends": [
                {
                    "target": b.target,
                    "healthy": b.healthy,
                    "draining": b.draining,
                    "role": b.role,
                    "methodCount": len(b.methods),
                }
                for b in self.backends
            ],
        }
