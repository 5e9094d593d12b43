"""The serving sidecar: a gRPC server over the PyTorch generation engine.

Port of `ggrmcp_tpu/serving/sidecar.py::Sidecar` for the generate path.
It registers GenerateService (Generate, GenerateStream) and
ModelInfoService (GetModelInfo, GetServingStats) under the reference's
service names (`ggrmcp.tpu.*`), plus reflection and health — so the
reference gateway discovers it by reflection and exposes the same tool
names as for the JAX sidecar.
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
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.rpc.server_utils import (
    HealthService,
    MethodDef,
    ReflectionService,
    add_service,
)
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, OverloadedError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer
from ggrmcp_tpu_torch.utils.device import DeviceLike

logger = logging.getLogger("ggrmcp.torch.sidecar")


def _prompt_tensor_ids(proto: serving_pb2.Tensor) -> list[int]:
    """An integer Tensor proto (raw little-endian bytes or int_values)
    → a flat list of token ids."""
    if proto.data:
        dtype = {"int32": np.int32, "int64": np.int64}.get(proto.dtype)
        if dtype is None:
            raise ValueError(f"prompt_ids dtype {proto.dtype!r} is not int")
        return np.frombuffer(proto.data, dtype=dtype).reshape(-1).tolist()
    return [int(v) for v in proto.int_values]


class Sidecar:
    """Owns the engine, the continuous batcher and the grpc.aio server.
    `params`: this package's weights (models/convert.py); None draws
    random weights from `seed` on the device."""

    def __init__(
        self,
        serving: Optional[ServingConfig] = None,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.serving = serving or ServingConfig()
        self.tokenizer = ByteTokenizer()
        model_cfg = llama_mod.get_config(self.serving.model)
        self.generation = GenerationEngine(
            model_cfg, self.serving, params=params, seed=seed, device=device
        )
        self.batcher = ContinuousBatcher(
            self.generation, self.serving.batching,
            eos_id=self.tokenizer.eos_id,
        )
        self.server: Optional[grpc.aio.Server] = None
        self.health = HealthService()
        self.port = 0
        self.target = ""

    # -- GenerateService ------------------------------------------------

    def _prompt_ids(self, request: serving_pb2.GenerateRequest) -> list[int]:
        if request.prompt_ids.shape or request.prompt_ids.int_values:
            return _prompt_tensor_ids(request.prompt_ids)
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
        info = self.generation.model_info()
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
        """The batcher's counters; the kwargs construction fails loudly
        if a stats() key drifts from the proto."""
        stats = dict(self.batcher.stats())
        stats["role"] = "mixed"
        return serving_pb2.ServingStatsResponse(**stats)

    # -- lifecycle ------------------------------------------------------

    async def start(self, port: Optional[int] = None) -> int:
        self.server = grpc.aio.server()
        services = ["ggrmcp.tpu.GenerateService", "ggrmcp.tpu.ModelInfoService"]
        add_service(
            self.server, "ggrmcp.tpu.GenerateService",
            {
                "Generate": MethodDef(
                    self.generate,
                    serving_pb2.GenerateRequest, serving_pb2.GenerateResponse,
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
        await asyncio.get_running_loop().run_in_executor(
            None, self.batcher.warmup
        )
        self.batcher.start()
        await self.server.start()
        logger.info(
            "sidecar serving %s on %s (%s)", self.serving.model, self.target,
            self.generation.device,
        )
        return self.port

    async def stop(self) -> None:
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
