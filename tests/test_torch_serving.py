"""Serving parity: the PyTorch port's engine, continuous batcher and
sidecar against the reference's, with the same tiny-llama weights (the
reference's init crossed through `params_from_numpy`), all greedy, so
token ids must be identical. Also: the overload shed, config guards,
and one MCP tools/call through the unchanged reference gateway in front
of the port's sidecar.
"""

import asyncio
import json

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, OverloadedError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
SMALL = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)


def _single_mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    cfg = jl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def engines(weights):
    jparams, tparams = weights
    jeng = JEngine(
        jl.CONFIGS["tiny-llama"], JServing(mesh=MeshConfig(tensor=1)),
        mesh=_single_mesh(), params=jparams,
    )
    teng = GenerationEngine(tl.CONFIGS["tiny-llama"], params=tparams,
                            device="cpu")
    return jeng, teng


def _prompts():
    rng = np.random.default_rng(0)
    # Short prompts take fused admission; 30 and 41 tokens exceed the
    # 16-token prefill_chunk and take chunked admission.
    return [
        rng.integers(3, 500, n).tolist() for n in (5, 12, 30, 9, 41, 16)
    ]


def test_engine_generate_matches_reference(engines):
    jeng, teng = engines
    prompts = _prompts()[:3]
    ref, ref_reasons = jeng.generate(prompts, max_new_tokens=10)
    out, reasons = teng.generate(prompts, max_new_tokens=10)
    assert out == ref
    assert reasons == ref_reasons
    streamed = list(teng.generate_stream(prompts[1], max_new_tokens=10))
    assert streamed == ref[1]


async def _run_all(batcher, prompts, max_new, sampling):
    async def one(prompt, seed):
        out, reason = [], None
        async for ids, reason in batcher.submit(prompt, max_new, sampling,
                                                seed=seed):
            out.extend(ids)
        return out, reason

    batcher.start()
    try:
        return await asyncio.gather(
            *(one(p, i) for i, p in enumerate(prompts))
        )
    finally:
        await batcher.stop()


async def test_batcher_matches_reference_both_routes(engines):
    jeng, teng = engines
    prompts = _prompts()
    ref = await _run_all(JBatcher(jeng, JBatching(**SMALL)), prompts, 7,
                         JSampling(temperature=0.0))
    port = ContinuousBatcher(teng, BatchingConfig(**SMALL))
    out = await _run_all(port, prompts, 7, SamplingConfig(temperature=0.0))
    assert out == ref
    # Both admission routes ran.
    assert port.fused_admissions > 0 and port.chunked_admissions > 0
    assert port.stats()["admit_rounds"] >= 1


async def test_batcher_decode_steps_per_tick(engines):
    """Multi-step ticks: overshoot tokens are dropped on the host and
    their cache writes past S_max land in the scratch slot."""
    _, teng = engines
    prompts = _prompts()[:4]
    one_step = await _run_all(
        ContinuousBatcher(teng, BatchingConfig(**SMALL)), prompts, 6,
        SamplingConfig(),
    )
    three = await _run_all(
        ContinuousBatcher(teng, BatchingConfig(
            **SMALL, decode_steps_per_tick=3)),
        prompts, 6, SamplingConfig(),
    )
    assert three == one_step


async def test_tick_failure_replays_without_changing_tokens(engines):
    """A decode tick that raises once: the active requests are replayed
    from prompt + emitted tokens on a fresh cache and finish with the
    tokens an undisturbed run gives."""
    _, teng = engines
    prompts = _prompts()[:3]
    clean = await _run_all(ContinuousBatcher(teng, BatchingConfig(**SMALL)),
                           prompts, 6, SamplingConfig())
    batcher = ContinuousBatcher(teng, BatchingConfig(**SMALL))
    real_tick = batcher._tick_impl
    calls = []

    def flaky_tick(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected tick failure")
        return real_tick(*args, **kwargs)

    batcher._tick_impl = flaky_tick
    out = await _run_all(batcher, prompts, 6, SamplingConfig())
    assert out == clean
    assert batcher.stats()["replayed_requests"] > 0


async def test_overloaded_past_max_pending(engines):
    _, teng = engines
    batcher = ContinuousBatcher(
        teng, BatchingConfig(max_batch_size=2, kv_cache_max_seq=64,
                             max_pending=2)
    )
    # Not started: submissions stay queued.
    batcher.submit([5, 6], 2, SamplingConfig())
    batcher.submit([7], 2, SamplingConfig())
    with pytest.raises(OverloadedError) as err:
        batcher.submit([8], 2, SamplingConfig())
    assert err.value.reason == "requests"
    assert batcher.stats()["shed_requests"] == 1


@pytest.mark.parametrize(
    "kind,field,value",
    [("batching", "paged_kv", "maybe"), ("batching", "speculative", "maybe"),
     ("batching", "prefill_interleave", "maybe"),
     ("batching", "prefix_cache_entries", -1),
     ("batching", "paged_kv_host_bytes", 1 << 20),
     ("batching", "paged_kv_host_path", "/tmp/kv.log"),
     ("batching", "paged_kv_host_file_bytes", 1 << 20),
     ("batching", "kv_tiers", [[128, 0]]),
     ("batching", "pipeline_ticks", "on"),
     ("batching", "queue_deadline_ms", -1.0),
     ("batching", "p50_budget_ms", -1.0),
     ("serving", "failpoints", "tick_fail:frequency=7"),
     ("serving", "kv_cache_dtype", "int4"), ("serving", "quantize", "fp4"),
     ("serving", "checkpoint_path", "ckpt"),
     ("serving", "speculative_draft_checkpoint", "ckpt"),
     ("serving", "speculative_gamma", 0)],
)
def test_unsupported_config_raises(kind, field, value):
    """Unported features' settings and values the reference's checks
    reject both raise, naming the field. A checkpoint path must name a
    checkpoint of the port's own format (serving/checkpoint.py); "ckpt"
    names none."""
    cls = BatchingConfig if kind == "batching" else ServingConfig
    with pytest.raises(ValueError, match=field):
        cls(**{field: value})


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tl.CONFIGS["tiny-llama"])


def _stub(channel, method, req_cls, resp_cls, stream=False):
    make = channel.unary_stream if stream else channel.unary_unary
    return make(
        method, request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


async def _generate_both(target):
    async with grpc.aio.insecure_channel(target) as channel:
        gen = _stub(channel, "/ggrmcp.tpu.GenerateService/Generate",
                    serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
        stream = _stub(channel, "/ggrmcp.tpu.GenerateService/GenerateStream",
                       serving_pb2.GenerateRequest, serving_pb2.GenerateChunk,
                       stream=True)
        unary = await asyncio.gather(*(
            gen(serving_pb2.GenerateRequest(
                prompt=p, max_new_tokens=8, return_tokens=True))
            for p in ("hello sidecar", "x" * 40, "abc")
        ))
        chunks = [c async for c in stream(serving_pb2.GenerateRequest(
            prompt="stream me", max_new_tokens=8, return_tokens=True))]
        info = await _stub(
            channel, "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
            serving_pb2.ModelInfoRequest, serving_pb2.ModelInfoResponse,
        )(serving_pb2.ModelInfoRequest())
        stats = await _stub(
            channel, "/ggrmcp.tpu.ModelInfoService/GetServingStats",
            serving_pb2.ServingStatsRequest, serving_pb2.ServingStatsResponse,
        )(serving_pb2.ServingStatsRequest())
    streamed = [t for c in chunks for t in c.token_ids]
    return [list(r.token_ids) for r in unary], streamed, chunks, info, stats


async def test_sidecar_and_gateway_match_reference():
    """gRPC Generate / GenerateStream on the port's sidecar return the
    JAX sidecar's token ids (same weights); then one MCP tools/call
    through the unchanged reference gateway returns those token ids."""
    import aiohttp

    from ggrmcp_tpu.core import config as cfgmod
    from ggrmcp_tpu.gateway.app import Gateway

    jside = JSidecar(
        JServing(mesh=MeshConfig(tensor=1),
                 batching=JBatching(**SMALL)),
        mesh=_single_mesh(),
    )
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jside.generation.params), CPU
    )
    tside = Sidecar(ServingConfig(batching=BatchingConfig(**SMALL)),
                    params=tparams, device="cpu")
    jport = await jside.start(0)
    tport = await tside.start(0)
    gw = None
    try:
        ref_unary, ref_stream, _, _, _ = await _generate_both(
            f"localhost:{jport}"
        )
        unary, streamed, chunks, info, stats = await _generate_both(
            f"localhost:{tport}"
        )
        assert unary == ref_unary and all(unary)
        assert streamed == ref_stream
        assert chunks[-1].done and chunks[-1].finish_reason in ("length",
                                                                "stop")
        assert info.model_id == "tiny-llama" and info.platform == "cpu"
        assert stats.total_slots == 4 and stats.ticks > 0

        cfg = cfgmod.default()
        cfg.server.host = "127.0.0.1"
        cfg.server.port = 0
        cfg.grpc.reconnect.enabled = False
        gw = Gateway(cfg, targets=[f"localhost:{tport}"])
        await gw.start()
        async with aiohttp.ClientSession(
            base_url=f"http://127.0.0.1:{gw.port}"
        ) as client:
            resp = await client.post("/", json={
                "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                "params": {
                    "name": "ggrmcp_tpu_generateservice_generate",
                    "arguments": {"prompt": "hello sidecar",
                                  "maxNewTokens": 8, "returnTokens": True},
                },
            })
            data = await resp.json()
        assert "error" not in data, data
        payload = json.loads(data["result"]["content"][0]["text"])
        assert payload["tokenIds"] == ref_unary[0]
    finally:
        if gw is not None:
            await gw.stop()
        await tside.stop()
        await jside.stop()
    assert tatt.flash_attention.launches == 0  # CPU: plain versions only
