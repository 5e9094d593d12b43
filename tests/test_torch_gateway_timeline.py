"""The reference's `test_timeline` cases against the port's timeline,
tracer, JSON log formatter and gateway (tests/torch_ref_cases.py). Its
endpoint cases put the port's gateway over a sidecar of the port on the
CPU (tests/torch_observed.py) where the reference puts its own, so one
trace id runs through the port's gateway span, the port's sidecar span,
its flight records and its ticks; its batcher-level cases keep the
reference's engine, whose records the port's timeline renders. Then the
port's sidecar's own spans (Generate, Embed) under the caller's trace
id."""

from tests import torch_ref_cases
from tests import torch_threads  # noqa: F401

torch_ref_cases.collect(torch_ref_cases.port_module(
    "test_timeline", redirect={"test_observability": "torch_observed"}),
    globals())


async def test_sidecar_spans_continue_the_callers_trace():
    """The port's sidecar opens the reference's spans: `sidecar.generate`
    and `sidecar.embed` in the tracer, under the trace id the caller
    sent as `x-trace-id` metadata."""
    import grpc.aio

    from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar
    from ggrmcp_tpu_torch.utils import tracing

    tracing.tracer.clear()
    calls = (("tiny-llama", "Generate", "/ggrmcp.tpu.GenerateService/Generate",
              serving_pb2.GenerateRequest(prompt="hi", max_new_tokens=2),
              serving_pb2.GenerateResponse),
             ("bert-tiny", "Embed", "/ggrmcp.tpu.EmbedService/Embed",
              serving_pb2.EmbedRequest(texts=["hi"]),
              serving_pb2.EmbedResponse))
    for model, name, path, request, response in calls:
        side = Sidecar(ServingConfig(model=model, batching=BatchingConfig(
            max_batch_size=2, kv_cache_max_seq=64)), device="cpu")
        await side.start(0)
        try:
            async with grpc.aio.insecure_channel(side.target) as ch:
                await ch.unary_unary(
                    path, request_serializer=type(request).SerializeToString,
                    response_deserializer=response.FromString)(
                    request, metadata=(("x-trace-id", f"t-{name}"),),
                    timeout=60)
        finally:
            await side.stop()
    spans = {s["name"]: s for s in tracing.tracer.recent()}
    assert spans["sidecar.generate"]["traceId"] == "t-Generate"
    assert spans["sidecar.generate"]["attrs"]["completion_tokens"] == 2
    assert spans["sidecar.embed"]["traceId"] == "t-Embed"
    assert spans["sidecar.embed"]["attrs"]["batch"] == 1
