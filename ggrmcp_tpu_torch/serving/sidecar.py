"""The serving sidecar: a gRPC server over the PyTorch engines.

Port of `ggrmcp_tpu/serving/sidecar.py::Sidecar`. The model's family
picks the engine: a llama model (by name, or any HF checkpoint through
`serving.hf_checkpoint_path`) gets the generation engine and the
continuous batcher, a bert model the embedding engine. Registration is
family-scoped as in the reference: GenerateService (Generate,
GenerateStream) or EmbedService (Embed), plus ModelInfoService
(GetModelInfo, GetServingStats), reflection and health, under the
reference's service names (`ggrmcp.tpu.*`) — so the reference gateway
discovers it by reflection and exposes the same tool names as for the
JAX sidecar.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import grpc
import grpc.aio
import numpy as np

from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.models import get_model
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.rpc.server_utils import (
    HealthService,
    MethodDef,
    ReflectionService,
    add_service,
)
from ggrmcp_tpu_torch.serving import tensors
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, OverloadedError
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine, GenerationEngine
from ggrmcp_tpu_torch.serving.tokenizer import load_tokenizer
from ggrmcp_tpu_torch.serving.weights import load_hf_checkpoint
from ggrmcp_tpu_torch.utils.device import DeviceLike

logger = logging.getLogger("ggrmcp.torch.sidecar")

POOLINGS = ("mean", "cls", "max")


class Sidecar:
    """Owns the engine (and, for generation, the continuous batcher) and
    the grpc.aio server. `params`: this package's weights
    (models/convert.py) for `serving.model`; None draws random weights
    from `seed` on the device. With `serving.hf_checkpoint_path` the
    architecture and the weights come from that checkpoint. With
    `serving.quantize="int8"` the weights reach the engine dense, loaded
    or drawn, and the engine quantizes them (the reference's order);
    `serving.synthetic_weights` draws the int8 weights directly."""

    def __init__(
        self,
        serving: Optional[ServingConfig] = None,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.serving = serving or ServingConfig()
        self.tokenizer = load_tokenizer(self.serving.tokenizer_path)
        self.generation: Optional[GenerationEngine] = None
        self.embedding: Optional[EmbeddingEngine] = None
        self.batcher: Optional[ContinuousBatcher] = None
        if self.serving.hf_checkpoint_path:
            if params is not None:
                raise ValueError(
                    "pass params or serving.hf_checkpoint_path, not both"
                )
            self.family = "llama"
            model_cfg, params = load_hf_checkpoint(
                self.serving.hf_checkpoint_path, device
            )
        else:
            self.family, model_cfg = get_model(self.serving.model)
        if self.family == "llama":
            self.generation = GenerationEngine(
                model_cfg, self.serving, params=params, seed=seed,
                device=device,
            )
            self.batcher = ContinuousBatcher(
                self.generation, self.serving.batching,
                eos_id=self.tokenizer.eos_id,
            )
        else:
            self.embedding = EmbeddingEngine(
                model_cfg, params=params, seed=seed, device=device
            )
        self.server: Optional[grpc.aio.Server] = None
        self.health = HealthService()
        self.port = 0
        self.target = ""

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

    async def _reject_unsupported(self, request, context) -> None:
        """Request features of the reference this package does not serve
        yet are the caller's error, never silently dropped."""
        if request.adapter:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "LoRA adapters are not supported by this sidecar",
            )
        spec = request.constraint
        if spec.json_schema or spec.tool_output_schema_ref:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "constrained decoding is not supported by this sidecar",
            )
        if request.kv_transfer_target:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "kv transfer is not supported by this sidecar",
            )

    def _max_new(self, request: serving_pb2.GenerateRequest) -> int:
        return min(
            request.max_new_tokens or 64,
            self.serving.batching.max_decode_steps,
        )

    async def _submit(self, request, context, prompt, unary: bool):
        try:
            return self.batcher.submit(
                prompt, self._max_new(request), self._sampling(request),
                request.sampling.seed or 0, unary=unary,
            )
        except OverloadedError as exc:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"server overloaded ({exc.reason}): {exc}; "
                f"retry in {exc.retry_after_s:g}s",
            )

    async def generate(self, request: serving_pb2.GenerateRequest, context):
        t0 = time.perf_counter()
        await self._reject_unsupported(request, context)
        prompt = self._prompt_ids(request)
        token_ids: list[int] = []
        finish = "length"
        it = await self._submit(request, context, prompt, unary=True)
        async for chunk_ids, reason in it:
            token_ids.extend(chunk_ids)
            if reason:
                finish = reason
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

    async def generate_stream(
        self, request: serving_pb2.GenerateRequest, context
    ):
        await self._reject_unsupported(request, context)
        prompt = self._prompt_ids(request)
        stops = list(request.stop)
        decoder = self.tokenizer.stream_decoder()
        text = ""
        emitted = ""
        it = await self._submit(request, context, prompt, unary=False)
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
                if reason == "error":
                    await context.abort(
                        grpc.StatusCode.INTERNAL,
                        "generation failed on the backend",
                    )
                yield serving_pb2.GenerateChunk(finish_reason=reason, done=True)
                return
        yield serving_pb2.GenerateChunk(finish_reason="length", done=True)

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
        else:
            stats = {"memory_weights_bytes": self.embedding.weight_bytes()}
        stats["role"] = "mixed"
        return serving_pb2.ServingStatsResponse(**stats)

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
        ReflectionService(services).attach(self.server)
        self.health.attach(self.server)
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
        await self.server.start()
        logger.info(
            "sidecar serving %s (%s) on %s (%s), tokenizer %s",
            engine.cfg.name, self.family, self.target, engine.device,
            type(self.tokenizer).__name__,
        )
        return self.port

    async def stop(self) -> None:
        if self.batcher is not None:
            await self.batcher.stop()
        if self.server is not None:
            await self.server.stop(grace=2.0)


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
