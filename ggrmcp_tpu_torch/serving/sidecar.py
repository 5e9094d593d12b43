"""The serving sidecar: a gRPC server over the PyTorch engines.

Port of `ggrmcp_tpu/serving/sidecar.py::Sidecar`. The model's family
picks the engine: a llama model (by name, or any HF checkpoint through
`serving.hf_checkpoint_path`) or a sparse-MoE model gets the generation
engine and the continuous batcher, a bert model the embedding engine.
`serving.num_layers` cuts a registry model's depth. Registration is
family-scoped as in the reference: GenerateService (Generate,
GenerateStream) or EmbedService (Embed), plus ModelInfoService
(GetModelInfo, GetServingStats), DebugService, reflection and health,
under the reference's service names (`ggrmcp.tpu.*`) — so the reference
gateway discovers it by reflection and exposes the same tool names as
for the JAX sidecar. A GenerateRequest's `constraint.json_schema` is compiled
once per schema (the sidecar's `GrammarCache`) and enforced by the
batcher; a bad schema is the caller's error (INVALID_ARGUMENT), a full
grammar arena an overload (RESOURCE_EXHAUSTED). A request's tenant and
QoS class come from its fields, else from the `x-tenant-id` /
`x-qos-class` metadata the gateway forwards. DebugService answers
Profile (a `torch.profiler` capture), GetFlightRecord and GetMemory,
which back the gateway's `/debug/*` routes.

Disaggregated serving (`serving.role`): every generate sidecar serves
KVTransferService.TransferKV, the receiving half of page shipping. A
Generate carrying `kv_transfer_target` is the prefill leg of a
two-leg call: this replica admits the prompt for one token, exports
its full pages and ships them to the target in in-order TransferKV
chunks, and answers finish_reason "transferred"; the gateway then
sends the request to the decode replica, whose admission reuses the
imported pages. Every transfer failure is typed (ABORTED), so the
gateway retries the call whole on a mixed replica. The wire format is
the reference's byte for byte: a replica of either package can ship to
one of the other.

Multi-LoRA (`serving.lora`): a request's `adapter` names its adapter,
resolved against the boot-time table or, with a registry, acquired
from the adapter arena through the batcher's host-op stream (typed:
INVALID_ARGUMENT for an unknown name, RESOURCE_EXHAUSTED for an arena
whose rows are all pinned, ABORTED for a failed load).

Length tiers (`batching.kv_tiers`): the batcher is a `TieredBatcher`,
one pool per tier; it refuses TransferKV imports (one arena per replica
is the transfer format). Speculative decoding
(`serving.speculative_draft`): with `batching.speculative=on` the
batcher's ticks draft and verify; off, unary greedy and plain
temperature calls whose prompts fit in one prefill chunk take the
micro-batcher (`serving/spec_batcher.py`), whole-generation calls
coalesced across concurrent requests.

Transport: `serving.uds_path` binds a unix socket only (target
`unix:{path}`, port 0; `stop()` removes the file), the co-launch's
private hop (serving/launcher.py). `serving.hf_checkpoint_optional`
serves `serving.model` with random weights, loudly, when the checkpoint
directory is absent.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import re
import tempfile
import time
from typing import Optional

import grpc
import grpc.aio
import numpy as np
import torch

from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.grammar import (
    CompiledGrammar,
    GrammarCache,
    GrammarCapacityError,
    GrammarError,
)
from ggrmcp_tpu_torch.models import family_module, get_model
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.rpc.server_utils import (
    HealthService,
    MethodDef,
    ReflectionService,
    add_service,
)
from ggrmcp_tpu_torch.serving import checkpoint, tensors
from ggrmcp_tpu_torch.serving.adapter_arena import (
    AdapterExhaustedError,
    AdapterLoadError,
    UnknownAdapterError,
)
from ggrmcp_tpu_torch.serving.batching import (
    ContinuousBatcher,
    KVTransferError,
    OverloadedError,
)
from ggrmcp_tpu_torch.serving.compile_watcher import watcher
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine, GenerationEngine
from ggrmcp_tpu_torch.serving.flight_recorder import FlightRecorder
from ggrmcp_tpu_torch.serving.pages import PageExhaustedError
from ggrmcp_tpu_torch.serving.scheduler import retry_after_for
from ggrmcp_tpu_torch.serving.spec_batcher import SpeculativeBatcher
from ggrmcp_tpu_torch.serving.tiered import TieredBatcher
from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer
from ggrmcp_tpu_torch.serving.weights import load_hf_checkpoint_sharded
from ggrmcp_tpu_torch.utils import failpoints, tracing
from ggrmcp_tpu_torch.utils.device import DeviceLike

logger = logging.getLogger("ggrmcp.torch.sidecar")

POOLINGS = ("mean", "cls", "max")


def _compile_records(limit: int = watcher.RING) -> list:
    """The compile watcher's newest `limit` events as CompileRecords."""
    return [serving_pb2.CompileRecord(
        fn_name=c.fn_name, t_wall=c.t_wall, duration_ms=c.duration_ms,
        post_warmup=c.post_warmup) for c in watcher.snapshot(limit)]


def _cut_depth(cfg, num_layers: int):
    """`cfg` with its first `num_layers` layers (0 = as registered)."""
    if not num_layers:
        return cfg
    if num_layers > cfg.num_layers:
        raise ValueError(
            f"serving.num_layers={num_layers} exceeds {cfg.name}'s "
            f"{cfg.num_layers} layers"
        )
    return dataclasses.replace(cfg, num_layers=num_layers)


class Sidecar:
    """Owns the engine (and, for generation, the continuous batcher) and
    the grpc.aio server. `params`: this package's weights
    (models/convert.py) for `serving.model`; None draws random weights
    from `seed` on the device. With `serving.hf_checkpoint_path` the
    architecture and the weights come from that checkpoint; with
    `serving.checkpoint_path` the weights of `serving.model` come from a
    checkpoint of the port's format (serving/checkpoint.py, what the
    trainer writes), loaded whole onto the mesh's first device and
    sharded by the engine. With
    `serving.quantize="int8"` the weights reach the engine dense, loaded
    or drawn, and the engine quantizes them (the reference's order);
    `serving.synthetic_weights` draws the int8 weights directly.

    The mesh (`mesh`, or `serving.mesh` over `device`'s platform) is
    built first, as in the reference, so that a checkpoint loads each
    shard straight onto its device (`load_hf_checkpoint_sharded`); the
    engine shards random or given weights itself."""

    def __init__(
        self,
        serving: Optional[ServingConfig] = None,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
        mesh: Optional[mesh_mod.Mesh] = None,
    ):
        self.serving = serving or ServingConfig()
        if mesh is None:
            mesh = mesh_mod.serving_mesh(self.serving.mesh, device)
        self.tokenizer = load_tokenizer(self.serving.tokenizer_path)
        self.generation: Optional[GenerationEngine] = None
        self.embedding: Optional[EmbeddingEngine] = None
        self.batcher: "Optional[ContinuousBatcher | TieredBatcher]" = None
        self.spec_batcher: Optional[SpeculativeBatcher] = None
        self.grammar_cache = GrammarCache(self.serving.grammar.cache_entries)
        hf_path = self.serving.hf_checkpoint_path
        if hf_path and not os.path.isdir(hf_path) and (
            self.serving.hf_checkpoint_optional
        ):
            # Only under the explicit opt-in: a config naming absent
            # weights otherwise fails start, never quietly serves noise.
            logger.warning(
                "hf checkpoint %s unobtainable; falling back to "
                "random-init %s (hf_checkpoint_optional=true — outputs "
                "are meaningless, geometry/tokenizer are real)",
                hf_path, self.serving.model,
            )
            hf_path = ""
        if hf_path:
            if params is not None:
                raise ValueError(
                    "pass params or serving.hf_checkpoint_path, not both"
                )
            self.family = "llama"
            model_cfg, params = load_hf_checkpoint_sharded(hf_path, mesh)
        else:
            self.family, model_cfg = get_model(self.serving.model)
            model_cfg = _cut_depth(model_cfg, self.serving.num_layers)
            if self.serving.checkpoint_path:
                if params is not None:
                    raise ValueError(
                        "pass params or serving.checkpoint_path, not both")
                shapes = (family_module(model_cfg).param_shapes(model_cfg)
                          if self.family in ("llama", "moe") else None)
                params = checkpoint.load_params(
                    self.serving.checkpoint_path, mesh.devices[0],
                    self.serving.model, shapes, "serving.checkpoint_path")
        if self.family in ("llama", "moe"):
            self.generation = GenerationEngine(
                model_cfg, self.serving, params=params, seed=seed,
                mesh=mesh,
            )
            make = (TieredBatcher if self.serving.batching.kv_tiers
                    else ContinuousBatcher)
            self.batcher = make(
                self.generation, self.serving.batching,
                eos_id=self.tokenizer.eos_id,
            )
            if (self.generation.draft_cfg is not None
                    and self.serving.batching.speculative != "on"):
                # The micro-path is the no-slot-pool fallback: with
                # speculative=on the batcher's tick drafts and verifies
                # (top-k, top-p and grammar rows too), and every request
                # goes there.
                self.spec_batcher = SpeculativeBatcher(
                    self.generation, self.serving.batching,
                    eos_id=self.tokenizer.eos_id,
                )
        else:
            self.embedding = EmbeddingEngine(
                model_cfg, params=params, seed=seed, serving=self.serving,
                mesh=mesh,
            )
        self.server: Optional[grpc.aio.Server] = None
        # One Profile capture at a time.
        self._profile_lock = asyncio.Lock()
        self.health = HealthService()
        self.port = 0
        self.target = ""
        # The role rides ServingStats for the gateway's role-aware
        # router. A non-mixed role needs a paged generate batcher (the
        # config checks the paging; the model family shows here): it can
        # neither export nor import pages otherwise.
        role = self.serving.role
        if role != "mixed" and (
            self.batcher is None or self.serving.batching.paged_kv != "on"
        ):
            raise ValueError(
                f"serving.role={role!r} requires a generate model with "
                "batching.paged_kv=on: KV pages are the transfer format"
            )
        self._transfer_stats = dict.fromkeys((
            "kv_transfers_sent", "kv_transfers_received",
            "kv_transfer_failures", "kv_transfer_pages_sent",
            "kv_transfer_pages_received", "kv_transfer_bytes_sent",
            "kv_transfer_bytes_received",
        ), 0)
        # Peer sidecar channels for outbound TransferKV, by target.
        self._peer_channels: dict[str, grpc.aio.Channel] = {}

    # -- EmbedService ---------------------------------------------------

    async def embed(self, request: serving_pb2.EmbedRequest, context):
        t0 = time.perf_counter()
        has_token_ids = (
            request.token_ids.shape
            or request.token_ids.int_values
            or request.token_ids.data
        )
        if has_token_ids:
            ids = tensors.from_proto(request.token_ids).astype(np.int32)
            token_lists = [
                _strip_trailing_pads(row) for row in np.atleast_2d(ids)
            ]
        elif request.texts:
            token_lists = [self.tokenizer.encode(t) for t in request.texts]
        else:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "texts or token_ids required"
            )
        token_lists = [t or [self.tokenizer.pad_id] for t in token_lists]
        pooling = request.pooling or "mean"
        if pooling not in POOLINGS:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unknown pooling {pooling!r}",
            )
        with tracing.tracer.span(
            "sidecar.embed",
            trace_id=tracing.trace_id_from_metadata(
                context.invocation_metadata()
            ) or None,
            model=self.embedding.cfg.name, batch=len(token_lists),
        ):
            vectors = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: self.embedding.embed(
                    token_lists, pooling, request.max_length
                ),
            )
        return serving_pb2.EmbedResponse(
            embeddings=tensors.to_proto(vectors),
            model_id=self.embedding.cfg.name,
            compute_ms=(time.perf_counter() - t0) * 1000,
        )

    # -- GenerateService ------------------------------------------------

    def _prompt_ids(self, request: serving_pb2.GenerateRequest) -> list[int]:
        if request.prompt_ids.shape or request.prompt_ids.int_values:
            return (
                tensors.from_proto(request.prompt_ids)
                .astype(np.int32).reshape(-1).tolist()
            )
        if request.prompt:
            return [self.tokenizer.bos_id] + self.tokenizer.encode(
                request.prompt
            )
        return [self.tokenizer.bos_id]

    @staticmethod
    def _sampling(request: serving_pb2.GenerateRequest) -> SamplingConfig:
        s = request.sampling
        return SamplingConfig(
            temperature=s.temperature,
            top_k=s.top_k,
            top_p=s.top_p if 0.0 < s.top_p < 1.0 else 1.0,
        )

    async def _resolve_adapter(self, request, context):
        """GenerateRequest.adapter → (served LoRA row, arena lease or
        None). Boot-time adapters resolve against the engine's table;
        the arena acquires residency through the batcher's serialized
        host-op stream (a first sighting loads the factors between
        ticks), and the lease pins the row until the request's terminal
        chunk. Unknown names are the caller's error (INVALID_ARGUMENT),
        an all-pinned arena is overload (RESOURCE_EXHAUSTED), a failed
        load ABORTED: the request never silently gets base weights."""
        name = request.adapter
        if self.generation.adapter_arena is None:
            try:
                return self.generation.resolve_adapter(name), None
            except ValueError as exc:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, str(exc)
                )
        if not name:
            return 0, None
        try:
            lease = await self.batcher.acquire_adapter(name)
        except UnknownAdapterError as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        except AdapterExhaustedError as exc:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"server overloaded (adapters): {exc}; "
                f"retry in {self._retry_after(''):g}s",
            )
        except AdapterLoadError as exc:
            await context.abort(grpc.StatusCode.ABORTED, str(exc))
        return lease.row, lease

    def _release_adapter(self, lease) -> None:
        """Return a lease whose request never reached the batcher; a
        submitted request's lease is released at its terminal chunk."""
        if lease is not None:
            self.batcher.release_adapter(lease)

    async def _resolve_grammar(
        self, request: serving_pb2.GenerateRequest, context
    ) -> Optional[CompiledGrammar]:
        """GenerateRequest.constraint → compiled DFA (LRU-cached by
        schema hash). Bad schemas, a disabled grammar, an unresolved
        tool reference and a tokenizer the DFA cannot align with all
        abort INVALID_ARGUMENT, as in the reference."""
        spec = request.constraint
        if not (spec.json_schema or spec.tool_output_schema_ref):
            return None
        if not self.serving.grammar.enabled:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "constrained decoding is disabled (serving.grammar.enabled)",
            )
        if not spec.json_schema:
            # The gateway resolves tool_output_schema_ref into an inline
            # schema (gateway.structured_output); the sidecar has no
            # tool registry.
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "constraint.tool_output_schema_ref must be resolved to "
                "an inline json_schema by the gateway",
            )
        if not isinstance(self.tokenizer, ByteTokenizer):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "constrained decoding requires the byte-level tokenizer "
                "(subword DFA alignment is not implemented)",
            )
        try:
            return self.grammar_cache.get(
                spec.json_schema,
                vocab_size=self.generation.cfg.vocab_size,
                eos_id=self.tokenizer.eos_id,
                max_states=self.serving.grammar.max_states,
                byte_offset=ByteTokenizer.OFFSET,
            )
        except GrammarError as exc:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"constraint schema rejected: {exc}",
            )

    def _max_new(self, request: serving_pb2.GenerateRequest) -> int:
        return min(
            request.max_new_tokens or 64,
            self.serving.batching.max_decode_steps,
        )

    def _retry_after(self, qos_class: str) -> float:
        """The class's Retry-After (the scheduler config's ladder, which
        applies with the scheduler off too)."""
        return retry_after_for(self.serving.scheduler, qos_class)

    @staticmethod
    def _maybe_replica_crash() -> None:
        """Failpoint `replica_crash`: a due evaluation ends the whole
        process at once (os._exit, as a SIGKILL would: no handler
        unwinds), the fault a supervisor must notice and restart."""
        try:
            failpoints.evaluate("replica_crash")
        except failpoints.FailpointError as exc:
            logger.critical("replica_crash failpoint fired: %s", exc)
            os._exit(86)

    @staticmethod
    def _tenant_identity(
        request: serving_pb2.GenerateRequest, context
    ) -> tuple[str, str]:
        """(tenant, qos_class) of a call: the request's fields win, else
        the forwarded metadata, tenant falling back through
        x-tenant-id, the adapter, x-adapter-id and x-session-id to
        "default". The class passes unvalidated: the SLO ledger files an
        unknown class under slo.default_class."""
        md: dict = {}
        for key, val in context.invocation_metadata() or ():
            if isinstance(val, str):
                md.setdefault(key.lower(), val)
        tenant = (
            request.tenant_id
            or md.get("x-tenant-id")
            or request.adapter
            or md.get("x-adapter-id")
            or md.get("x-session-id")
            or "default"
        )
        qos = request.qos_class or md.get("x-qos-class") or ""
        return str(tenant), str(qos)

    async def _submit(self, request, context, prompt, unary: bool,
                      prefill_leg: bool = False):
        """Hand a request to the batcher; returns (its chunk iterator,
        its QoS class). The grammar resolves first (its aborts hold no
        lease), then the adapter, whose lease returns to the arena if
        the submit sheds. The prefill leg of a two-leg call admits for
        one greedy token, unconstrained (the token is discarded)."""
        grammar = (None if prefill_leg
                   else await self._resolve_grammar(request, context))
        adapter, lease = await self._resolve_adapter(request, context)
        tenant, qos_class = self._tenant_identity(request, context)
        trace_id = tracing.trace_id_from_metadata(
            context.invocation_metadata())
        try:
            it = self.batcher.submit(
                prompt,
                1 if prefill_leg else self._max_new(request),
                (SamplingConfig(temperature=0.0) if prefill_leg
                 else self._sampling(request)),
                0 if prefill_leg else (request.sampling.seed or 0),
                unary=unary, grammar=grammar, trace_id=trace_id,
                tenant=tenant, qos_class=qos_class, adapter=adapter,
                adapter_key=request.adapter, adapter_lease=lease,
            )
            return it, qos_class
        except OverloadedError as exc:
            self._release_adapter(lease)
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"server overloaded ({exc.reason}): {exc}; "
                f"retry in {exc.retry_after_s:g}s",
            )
        except GrammarCapacityError as exc:
            # Too many distinct schemas decoding at once: transient.
            self._release_adapter(lease)
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))

    async def _abort_overloaded(self, context, qos_class: str) -> None:
        """A paged arena that cannot hold the request at admission (after
        submit queued it): the same typed overload as a submit-time
        shed."""
        await context.abort(
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            f"server overloaded (pages): kv page pool exhausted; "
            f"retry in {self._retry_after(qos_class):g}s",
        )

    async def generate(self, request: serving_pb2.GenerateRequest, context):
        self._maybe_replica_crash()
        t0 = time.perf_counter()
        prompt = self._prompt_ids(request)
        if request.kv_transfer_target:
            # The prefill leg of a disaggregated call: prefill only, ship
            # the pages, answer "transferred".
            return await self._prefill_and_ship(request, context, prompt, t0)
        token_ids: list[int] = []
        finish = "length"
        trace_id = tracing.trace_id_from_metadata(
            context.invocation_metadata())
        with tracing.tracer.span(
            "sidecar.generate", trace_id=trace_id or None,
            model=self.generation.cfg.name, prompt_tokens=len(prompt),
        ) as span:
            speculative = self._speculative_route(request, prompt)
            if speculative:
                token_ids, finish = await self._generate_speculative(
                    request, context, prompt)
            else:
                it, qos_class = await self._submit(request, context, prompt,
                                                   unary=True)
                async for chunk_ids, reason in it:
                    token_ids.extend(chunk_ids)
                    if reason:
                        finish = reason
            span.set(completion_tokens=len(token_ids), finish=finish)
            self._attribute_span(span, trace_id, speculative)
        if finish == "overloaded":
            await self._abort_overloaded(context, qos_class)
        if finish == "error":
            await context.abort(
                grpc.StatusCode.INTERNAL, "generation failed on the backend"
            )
        text = self.tokenizer.decode(token_ids)
        text, finish = _apply_stops(text, list(request.stop), finish)
        return serving_pb2.GenerateResponse(
            text=text,
            token_ids=token_ids if request.return_tokens else [],
            finish_reason=finish,
            prompt_tokens=len(prompt),
            completion_tokens=len(token_ids),
            model_id=self.generation.cfg.name,
            compute_ms=(time.perf_counter() - t0) * 1000,
        )

    def _attribute_span(self, span, trace_id: str, speculative: bool) -> None:
        """Stamp the flight recorder's lifecycle of this call onto its
        span (ttft_ms, queue_ms and the tick range), so one trace id
        walks span → request record → tick records."""
        if not trace_id:
            return
        source = (self.spec_batcher.recorder if speculative
                  else self.batcher)
        rec = source.request_record(trace_id)
        if rec is None:
            return
        span.set(
            ttft_ms=round(rec.ttft_ms, 3),
            queue_ms=round(rec.queue_ms, 3),
            first_tick=rec.first_tick,
            last_tick=rec.last_tick,
        )

    def _speculative_route(self, request, prompt: list[int]) -> bool:
        """Whether a unary call takes the micro-batcher: greedy (lossless,
        bitwise) and plain temperature sampling (rejection sampling,
        lossless in distribution); its whole-generation program has no
        top-k / top-p filter and no grammar mask, so those take the
        batcher, as do prompts longer than one prefill chunk (prefill-
        bound: the draft would double the prefill and bypass chunked
        admission). Adapters cannot reach this: the engine refuses LoRA
        with a draft."""
        s = request.sampling
        constraint = request.constraint
        return (
            self.spec_batcher is not None
            and s.top_k <= 0
            and not 0.0 < s.top_p < 1.0
            and len(prompt) <= self.serving.batching.prefill_chunk
            and not (constraint.json_schema
                     or constraint.tool_output_schema_ref)
        )

    async def _generate_speculative(self, request, context, prompt):
        """One unary call through the micro-batcher: (tokens, finish)."""
        trace_id = tracing.trace_id_from_metadata(
            context.invocation_metadata())
        try:
            ids, finish, _ = await self.spec_batcher.submit(
                prompt, self._max_new(request),
                temperature=max(0.0, request.sampling.temperature),
                seed=request.sampling.seed or 0, trace_id=trace_id,
            )
        except asyncio.CancelledError:
            raise  # a client disconnect must cancel, not "error"
        except Exception:
            logger.exception("speculative generation failed")
            return [], "error"
        return ids, finish

    async def generate_stream(
        self, request: serving_pb2.GenerateRequest, context
    ):
        self._maybe_replica_crash()
        prompt = self._prompt_ids(request)
        if request.kv_transfer_target:
            # The same prefill leg as unary Generate; the stream carries
            # one terminal "transferred" chunk.
            await self._prefill_and_ship(request, context, prompt,
                                         time.perf_counter())
            yield serving_pb2.GenerateChunk(
                finish_reason="transferred", done=True)
            return
        stops = list(request.stop)
        decoder = self.tokenizer.stream_decoder()
        text = ""
        emitted = ""
        it, qos_class = await self._submit(request, context, prompt,
                                           unary=False)
        async for chunk_ids, reason in it:
            text += decoder.feed(chunk_ids)
            final = reason is not None
            if final:
                text += decoder.flush()
            stable, stop_hit = _apply_stops(text, stops, "")
            delta = stable[len(emitted):] if len(stable) >= len(emitted) else ""
            if delta:
                emitted += delta
                yield serving_pb2.GenerateChunk(
                    text_delta=delta,
                    token_ids=chunk_ids if request.return_tokens else [],
                )
            if stop_hit == "stop_string":
                yield serving_pb2.GenerateChunk(
                    finish_reason="stop_string", done=True
                )
                return
            if final:
                if reason == "overloaded":
                    await self._abort_overloaded(context, qos_class)
                if reason == "error":
                    await context.abort(
                        grpc.StatusCode.INTERNAL,
                        "generation failed on the backend",
                    )
                yield serving_pb2.GenerateChunk(finish_reason=reason, done=True)
                return
        yield serving_pb2.GenerateChunk(finish_reason="length", done=True)

    # -- KVTransferService: sidecar-to-sidecar page shipping ----------------

    # Payload bytes per TransferKV chunk: under the default 4 MB gRPC
    # message cap with the proto's overhead. A llama3-8b page (16
    # positions, K and V over 32 layers in bf16) is 2 MiB, so one page
    # rides each call. Each chunk is self-contained (prompt +
    # start_page): a failed transfer leaves only a valid shorter prefix.
    TRANSFER_CHUNK_BYTES = 2 << 20

    def _transfer_call(self, target: str):
        """Cached unary stub for a peer sidecar's TransferKV."""
        channel = self._peer_channels.get(target)
        if channel is None:
            channel = grpc.aio.insecure_channel(target)
            self._peer_channels[target] = channel
        return channel.unary_unary(
            "/ggrmcp.tpu.KVTransferService/TransferKV",
            request_serializer=serving_pb2.KVTransferRequest.SerializeToString,
            response_deserializer=serving_pb2.KVTransferResponse.FromString,
        )

    async def _ship_kv(self, target: str, prompt: list[int], export: dict,
                       adapter: str = "") -> tuple[int, int]:
        """Stream one exported prompt's pages to a peer sidecar as
        in-order TransferKV chunks. Returns (pages, wire bytes); a
        failure propagates to _prefill_and_ship's typed ABORTED."""
        n = export["pages"]
        per_page = max(1, sum(
            a.nbytes for a in export.values() if isinstance(a, torch.Tensor)
        ) // n)
        per_chunk = max(1, self.TRANSFER_CHUNK_BYTES // per_page)
        call = self._transfer_call(target)
        quantized = "k_scale" in export
        sent_bytes = 0
        for start in range(0, n, per_chunk):
            end = min(n, start + per_chunk)
            # The page codec the host tier stores pages with.
            payload = tensors.kv_pages_to_payload(
                export["k"][:, start:end],
                export["v"][:, start:end],
                export["k_scale"][:, start:end] if quantized else None,
                export["v_scale"][:, start:end] if quantized else None,
            )
            chunk = serving_pb2.KVTransferRequest(
                prompt_ids=prompt,
                page_size=export["page_size"],
                start_page=start,
                total_pages=n,
                k_pages=payload.k,
                v_pages=payload.v,
                kv_dtype=self.serving.kv_cache_dtype,
                model_id=self.generation.cfg.name,
                done=end == n,
                adapter=adapter,
            )
            if quantized:
                chunk.k_scales.CopyFrom(payload.k_scales)
                chunk.v_scales.CopyFrom(payload.v_scales)
            sent_bytes += chunk.ByteSize()
            await call(chunk, timeout=30.0)
        return n, sent_bytes

    async def _prefill_and_ship(self, request, context, prompt: list[int],
                                t0: float):
        """The prefill-role leg of a disaggregated call: admit the
        prompt for ONE greedy token (the admission computes and indexes
        the prompt's page chain; the token is discarded, so the decode
        replica samples every output token itself), export the chain
        under the request's adapter domain, ship it to the target.
        Every failure is typed ABORTED ("kv transfer failed"), so the
        gateway retries the whole call on a mixed replica."""
        target = request.kv_transfer_target
        # Clamp with the request's max_new and grammar flag: the chain
        # shipped must be the one the decode replica's identically
        # clamped admission looks up.
        spec = request.constraint
        constrained = bool(spec.json_schema or spec.tool_output_schema_ref)
        clamp = getattr(self.batcher, "clamp_prompt", None)
        if clamp is not None:
            # A tiered batcher cannot export: the export below fails
            # typed (ABORTED).
            prompt = clamp(prompt, self._max_new(request),
                           constrained=constrained)
        try:
            failpoints.evaluate("kv_transfer_fail")
        except failpoints.FailpointError as exc:
            self._transfer_stats["kv_transfer_failures"] += 1
            await context.abort(
                grpc.StatusCode.ABORTED,
                f"kv transfer failed (injected): {exc}",
            )
        it, _ = await self._submit(request, context, prompt, unary=True,
                                   prefill_leg=True)
        finish = "error"
        async for _ids, reason in it:
            if reason:
                finish = reason
        if finish not in ("stop", "length", "grammar_complete"):
            self._transfer_stats["kv_transfer_failures"] += 1
            await context.abort(
                grpc.StatusCode.ABORTED,
                f"kv transfer failed: prefill finished {finish!r}",
            )
        try:
            export = await self.batcher.run_host_op(
                lambda: self.batcher.export_prompt_kv(
                    prompt, adapter=request.adapter))
            pages, wire_bytes = await self._ship_kv(
                target, prompt, export, adapter=request.adapter)
        except asyncio.CancelledError:
            raise  # a client disconnect cancels, it is no failure
        except Exception as exc:  # noqa: BLE001 — typed ABORTED below
            self._transfer_stats["kv_transfer_failures"] += 1
            logger.warning("kv transfer to %s failed: %s", target, exc)
            await context.abort(
                grpc.StatusCode.ABORTED, f"kv transfer failed: {exc}"
            )
        self._transfer_stats["kv_transfers_sent"] += 1
        self._transfer_stats["kv_transfer_pages_sent"] += pages
        self._transfer_stats["kv_transfer_bytes_sent"] += wire_bytes
        logger.info(
            "kv transfer: %d pages (%d bytes) of a %d-token prompt "
            "shipped to %s", pages, wire_bytes, len(prompt), target,
        )
        return serving_pb2.GenerateResponse(
            finish_reason="transferred",
            prompt_tokens=len(prompt),
            model_id=self.generation.cfg.name,
            compute_ms=(time.perf_counter() - t0) * 1000,
        )

    async def transfer_kv(self, request: serving_pb2.KVTransferRequest,
                          context):
        """Receive one KV page chunk into this replica's arena. The
        pages land at refcount 0 in the prefix index (evictable, like a
        finished request's pages), and the device write runs in the
        batcher's serialized stream, so no tick or admission sees a
        half-written page."""
        batcher = self.batcher
        if not isinstance(batcher, ContinuousBatcher) or not batcher._paged:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "kv import requires a paged, non-tiered batcher "
                "(batching.paged_kv=on)",
            )
        if (request.kv_dtype or "") != (self.serving.kv_cache_dtype or ""):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"kv dtype mismatch: sender {request.kv_dtype!r} vs "
                f"receiver {self.serving.kv_cache_dtype!r}",
            )
        if request.page_size != batcher._page_size:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"page size mismatch: sender {request.page_size} vs "
                f"receiver {batcher._page_size}",
            )
        payload = serving_pb2.KVPagePayload(
            k=request.k_pages, v=request.v_pages)
        if request.HasField("k_scales"):
            payload.k_scales.CopyFrom(request.k_scales)
            payload.v_scales.CopyFrom(request.v_scales)
        k, v, k_scale, v_scale = tensors.kv_pages_from_payload(payload)
        prompt = list(request.prompt_ids)
        start = int(request.start_page)
        try:
            imported, present = await batcher.run_host_op(
                lambda: batcher.import_prompt_kv(
                    prompt, start, k, v, k_scale, v_scale,
                    adapter=request.adapter,
                )
            )
        except PageExhaustedError as exc:
            # The receiving arena is full even after eviction: the
            # overload ladder of an admission shed.
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except (KVTransferError, ValueError) as exc:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        self._transfer_stats["kv_transfer_pages_received"] += imported
        self._transfer_stats["kv_transfer_bytes_received"] += (
            request.ByteSize())
        if request.done:
            self._transfer_stats["kv_transfers_received"] += 1
        return serving_pb2.KVTransferResponse(
            pages_imported=imported, pages_present=present)

    # -- ModelInfoService -----------------------------------------------

    async def get_model_info(self, request, context):
        info = (self.generation or self.embedding).model_info()
        return serving_pb2.ModelInfoResponse(
            model_id=info["model_id"],
            family=info["family"],
            num_params_million=info["num_params_million"],
            max_seq_len=info["max_seq_len"],
            dtype=info["dtype"],
            mesh=info["mesh"],
            num_devices=info["num_devices"],
            platform=info["platform"],
        )

    async def get_serving_stats(self, request, context):
        """The batcher's counters; an embed-only sidecar has no batcher
        and exports its weights' bytes alone. The kwargs construction
        fails loudly if a stats() key drifts from the proto."""
        if self.batcher is not None:
            stats = dict(self.batcher.stats())
            stats["grammar_compiles"] = self.grammar_cache.compiles
            stats["grammar_cache_hits"] = self.grammar_cache.hits
        else:
            comp = self.embedding.ledger.component_bytes()
            stats = {"memory_weights_bytes": comp.get(("", "weights"), 0)}
        if self.spec_batcher is not None:
            sb = self.spec_batcher
            stats["speculative_calls"] = sb.calls
            stats["speculative_requests"] = sb.requests
            stats["speculative_drafted"] = sb.drafted
            stats["speculative_accepted"] = sb.accepted
            stats["queued_requests"] = (
                stats.get("queued_requests", 0) + sb.queue.qsize())
            # Histograms sum by construction: the exported latency
            # distributions cover both serving paths.
            spec_hist = sb.recorder.histogram_stats()
            batch_hist = {k: stats.pop(k) for k in list(spec_hist)
                          if k in stats}
            stats.update(FlightRecorder.merge_histogram_stats(
                [batch_hist, spec_hist]))
        # The role and the transfer plane's counters, which the
        # gateway's role-aware router reads from the same snapshot.
        stats["role"] = self.serving.role
        stats.update(self._transfer_stats)
        # The compile watcher's process-level counters (fields 101-105,
        # gateway_backend_compile_*): the port's kernel builds and loads.
        stats.update(watcher.stats())
        return serving_pb2.ServingStatsResponse(**stats)

    # -- DebugService ---------------------------------------------------

    async def profile(self, request: serving_pb2.ProfileRequest, context):
        """A `torch.profiler` capture of `duration_ms` (default 1 s, 10 ms
        to 60 s), written as a Chrome trace under the server's base
        directory: the client's `output_dir` is reduced to a
        [A-Za-z0-9._-] label there, so no caller can write elsewhere.
        One capture at a time (FAILED_PRECONDITION); a failed capture
        (on a card: one that saw no kernel) is INTERNAL."""
        duration_ms = (
            1000.0 if not request.duration_ms
            else float(min(max(request.duration_ms, 10), 60_000))
        )
        label = re.sub(r"[^A-Za-z0-9._-]", "_", os.path.basename(
            request.output_dir or ""
        ))
        if not label.strip("."):  # "", "." and ".." all escape the base
            label = f"capture-{int(time.time())}"
        out = os.path.join(tempfile.gettempdir(), "ggrmcp-profiles", label)
        if self._profile_lock.locked():
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "a profile capture is already running",
            )
        engine = self.generation or self.embedding
        async with self._profile_lock:
            try:
                path = await asyncio.get_running_loop().run_in_executor(
                    None, tracing.profile_capture, duration_ms, out,
                    engine.device.type == "cuda",
                )
            except asyncio.CancelledError:
                raise  # a cancelled RPC must not abort() a dead context
            except Exception as exc:
                logger.exception("profile capture failed")
                await context.abort(
                    grpc.StatusCode.INTERNAL, f"profile capture failed: {exc}"
                )
        logger.info("profile capture (%.0f ms) written to %s", duration_ms,
                    path)
        return serving_pb2.ProfileResponse(
            output_path=path, duration_ms=duration_ms
        )

    async def get_flight_record(
        self, request: serving_pb2.FlightRecordRequest, context
    ):
        """The flight recorder's tick and request records, filtered to
        one trace id and (requests only) one tenant when given, and the
        compile watcher's ring (newest last). Host state only."""
        ticks: list = []
        requests: list = []
        enabled = False
        max_requests = request.max_requests or 128
        if self.batcher is not None:
            enabled = any(
                t.recorder.enabled
                for t in getattr(self.batcher, "tiers", [self.batcher]))
            ticks, requests = self.batcher.flight_snapshot(
                request.max_ticks or 128, max_requests,
                request.trace_id, request.tenant,
            )
        if self.spec_batcher is not None:
            # The micro-path's request records (one-shot calls, no
            # ticks), merged by submit time.
            enabled = enabled or self.spec_batcher.recorder.enabled
            spec_requests = [
                r for r in self.spec_batcher.recorder.request_snapshot()
                if (not request.trace_id or r.trace_id == request.trace_id)
                and (not request.tenant or r.tenant == request.tenant)
            ]
            requests = sorted(requests + spec_requests,
                              key=lambda r: r.t_submit)[-max_requests:]
        return serving_pb2.FlightRecordResponse(
            # Kernel builds and loads ride the flight record, so the
            # timeline renders each as an instant beside the ticks.
            compiles=_compile_records(request.max_ticks or 128),
            ticks=[
                serving_pb2.TickRecord(
                    seq=t.seq, t_wall=t.t_wall, t_mono=t.t_mono,
                    duration_ms=t.duration_ms, active_slots=t.active_slots,
                    admitted=t.admitted, finished=t.finished,
                    interleaved_rows=t.interleaved_rows,
                    shed_total=t.shed_total, replayed_total=t.replayed_total,
                    timed_out_total=t.timed_out_total,
                    trace_ids=t.trace_ids, source=t.source,
                    spec_drafted=t.spec_drafted,
                    spec_accepted=t.spec_accepted,
                    kv_pages_in_use=t.kv_pages_in_use,
                    phase_admit_ms=t.phase_admit_ms,
                    phase_sync_ms=t.phase_sync_ms,
                    phase_dispatch_ms=t.phase_dispatch_ms,
                    phase_wait_ms=t.phase_wait_ms,
                    phase_host_ms=t.phase_host_ms,
                    memory_components=list(t.memory),
                    memory_component_bytes=[int(b) for b in t.memory.values()],
                )
                for t in ticks
            ],
            requests=[
                serving_pb2.RequestRecord(
                    trace_id=r.trace_id, t_submit=r.t_submit,
                    queue_ms=r.queue_ms, ttft_ms=r.ttft_ms, e2e_ms=r.e2e_ms,
                    prompt_tokens=r.prompt_tokens, tokens=r.tokens,
                    finish_reason=r.finish_reason, decode_tps=r.decode_tps,
                    first_tick=r.first_tick, last_tick=r.last_tick,
                    source=r.source, constrained=r.constrained,
                    tenant=r.tenant, qos_class=r.qos_class,
                    slo_violated=r.slo_violated,
                )
                for r in requests
            ],
            enabled=enabled,
        )

    async def get_memory(self, request: serving_pb2.MemoryRequest, context):
        """The memory ledger: bytes per (scope, component) and, with
        `reconcile`, the device's live bytes split into attributed and
        unattributed (attributed + unattributed == live), and the host
        components, and the compile watcher's counters and ring. The
        walks run in the executor."""
        ledger = (self.generation or self.embedding).ledger
        components: list = []
        total = live = unattr_bytes = unattr_arrays = 0
        if ledger.enabled:
            loop = asyncio.get_running_loop()
            if request.reconcile:
                rec = await loop.run_in_executor(None, ledger.reconcile)
                live = rec["live_bytes"]
                unattr_bytes = rec["unattributed_bytes"]
                unattr_arrays = len(rec["unattributed_arrays"])
                per = {}
                for name, b in rec["components"].items():
                    scope, _, comp = name.rpartition("/")
                    per[(scope, comp)] = b
            else:
                per = await loop.run_in_executor(
                    None, ledger.component_bytes)
            for (scope, comp), b in sorted(per.items()):
                components.append(serving_pb2.MemoryComponent(
                    component=comp, scope=scope, bytes=int(b)
                ))
                total += int(b)
        host = [
            serving_pb2.HostMemoryComponent(
                component=comp, scope=scope, bytes=int(info.get("bytes", 0)),
                entries=int(info.get("entries", 0)),
                budget_bytes=int(info.get("budget_bytes", 0)),
                file_path=str(info.get("file_path", "")),
                file_bytes=int(info.get("file_bytes", 0)),
                file_entries=int(info.get("file_entries", 0)))
            for (scope, comp), info in sorted(ledger.host_components().items())
        ]
        return serving_pb2.MemoryResponse(
            components=components,
            total_bytes=total,
            host=host,
            host_total_bytes=sum(h.bytes for h in host),
            live_bytes=live,
            unattributed_bytes=unattr_bytes,
            unattributed_arrays=unattr_arrays,
            enabled=ledger.enabled,
            **watcher.stats(),
            compiles=_compile_records(),
        )

    # -- lifecycle ------------------------------------------------------

    async def start(self, port: Optional[int] = None) -> int:
        self.server = grpc.aio.server()
        # Only the services of this model's family: a gateway pooling an
        # embed sidecar and a generate sidecar must not see colliding
        # tool names (discovery is name-keyed).
        services = ["ggrmcp.tpu.ModelInfoService"]
        if self.embedding is not None:
            services.append("ggrmcp.tpu.EmbedService")
            add_service(
                self.server, "ggrmcp.tpu.EmbedService",
                {"Embed": MethodDef(
                    self.embed,
                    serving_pb2.EmbedRequest, serving_pb2.EmbedResponse,
                )},
            )
        if self.generation is not None:
            services.append("ggrmcp.tpu.GenerateService")
            add_service(
                self.server, "ggrmcp.tpu.GenerateService",
                {
                    "Generate": MethodDef(
                        self.generate,
                        serving_pb2.GenerateRequest,
                        serving_pb2.GenerateResponse,
                    ),
                    "GenerateStream": MethodDef(
                        self.generate_stream,
                        serving_pb2.GenerateRequest, serving_pb2.GenerateChunk,
                        server_streaming=True,
                    ),
                },
            )
            # Every generate replica receives pages: a mixed one too, or
            # a decode replica's drain would leave transfers nowhere to
            # land.
            services.append("ggrmcp.tpu.KVTransferService")
            add_service(
                self.server, "ggrmcp.tpu.KVTransferService",
                {"TransferKV": MethodDef(
                    self.transfer_kv,
                    serving_pb2.KVTransferRequest,
                    serving_pb2.KVTransferResponse,
                )},
            )
        add_service(
            self.server, "ggrmcp.tpu.ModelInfoService",
            {
                "GetModelInfo": MethodDef(
                    self.get_model_info,
                    serving_pb2.ModelInfoRequest,
                    serving_pb2.ModelInfoResponse,
                ),
                "GetServingStats": MethodDef(
                    self.get_serving_stats,
                    serving_pb2.ServingStatsRequest,
                    serving_pb2.ServingStatsResponse,
                ),
            },
        )
        services.append("ggrmcp.tpu.DebugService")
        add_service(
            self.server, "ggrmcp.tpu.DebugService",
            {
                "Profile": MethodDef(
                    self.profile,
                    serving_pb2.ProfileRequest, serving_pb2.ProfileResponse,
                ),
                "GetFlightRecord": MethodDef(
                    self.get_flight_record,
                    serving_pb2.FlightRecordRequest,
                    serving_pb2.FlightRecordResponse,
                ),
                "GetMemory": MethodDef(
                    self.get_memory,
                    serving_pb2.MemoryRequest, serving_pb2.MemoryResponse,
                ),
            },
        )
        ReflectionService(services).attach(self.server)
        self.health.attach(self.server)
        uds = self.serving.uds_path
        if uds:
            # A unix socket only, no TCP listener. gRPC returns 1 for a
            # successful unix bind, so `port` stays 0.
            if self.server.add_insecure_port(f"unix:{uds}") == 0:
                raise OSError(f"failed to bind unix:{uds}")
            self.port = 0
            self.target = f"unix:{uds}"
        else:
            bind = port if port is not None else self.serving.port
            self.port = self.server.add_insecure_port(f"0.0.0.0:{bind}")
            self.target = f"localhost:{self.port}"
        # Build the kernels before accepting traffic (device-bound →
        # executor, not the event loop).
        engine = self.generation or self.embedding
        await asyncio.get_running_loop().run_in_executor(
            None, self.batcher.warmup if self.batcher else engine.warmup
        )
        if self.batcher is not None:
            self.batcher.start()
        if self.spec_batcher is not None:
            self.spec_batcher.start()
        # Warmup is over: from here every kernel build or load is a
        # steady-state compile — counted, WARNING-logged and a timeline
        # instant (serving/compile_watcher.py).
        watcher.mark_warm()
        await self.server.start()
        logger.info(
            "sidecar serving %s (%s) on %s (%s), tokenizer %s",
            engine.cfg.name, self.family, self.target, engine.device,
            type(self.tokenizer).__name__,
        )
        return self.port

    async def stop(self) -> None:
        for channel in self._peer_channels.values():
            try:
                await channel.close()
            except asyncio.CancelledError:
                raise  # a cancelled shutdown must not swallow itself
            except Exception:  # noqa: BLE001 — the peer may be gone
                pass
        self._peer_channels.clear()
        if self.batcher is not None:
            await self.batcher.stop()
        if self.spec_batcher is not None:
            await self.spec_batcher.stop()
        if self.server is not None:
            await self.server.stop(grace=2.0)
        if self.serving.uds_path:
            try:
                os.unlink(self.serving.uds_path)
            except FileNotFoundError:
                pass


def _apply_stops(text: str, stops: list[str], finish: str) -> tuple[str, str]:
    """Truncate at the earliest stop string, if any."""
    cut = -1
    for stop in stops:
        if not stop:
            continue
        idx = text.find(stop)
        if idx >= 0 and (cut < 0 or idx < cut):
            cut = idx
    if cut >= 0:
        return text[:cut], "stop_string"
    return text, finish


def _strip_trailing_pads(row: np.ndarray) -> list[int]:
    """Strip only TRAILING zeros (padding); interior zeros are real ids."""
    nonzero = np.nonzero(row)[0]
    if len(nonzero) == 0:
        return []
    return row[: nonzero[-1] + 1].tolist()
