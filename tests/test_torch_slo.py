"""SLO and tenant accounting in the port's batcher against the JAX
package's: the same tiny-llama weights, float32, greedy, one mixed
sequence of classes and tenants (and a submit-time shed), with class
targets every request clearly meets (1e9 ms) or clearly violates (1e-3
ms). Per-class met / violated / unevaluated totals and per-tenant VTC
token counts must be equal. A request's tenant and QoS class resolve by
the reference's precedence, over gRPC through the port's sidecar.
"""

import asyncio

import grpc
import pytest

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import SloConfig as JSlo
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.batching import OverloadedError as JOverloaded
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    SchedulerConfig,
    ServingConfig,
    SloConfig,
)
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, OverloadedError
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests.test_torch_observability import engines, serving_view  # noqa: F401
from tests import torch_threads  # noqa: F401

CLASSES = {
    "fast": {"ttft_p99_ms": 1e-3, "tpot_p99_ms": 1e-3},
    "lax": {"ttft_p99_ms": 1e9, "tpot_p99_ms": 1e9},
}
CFG = dict(max_batch_size=4, kv_cache_max_seq=128, prefill_chunk=16,
           max_pending=6, max_queue_delay_ms=1000.0)
# (prompt, max_new, tenant, qos_class); "" and "gold" degrade to the
# default class (lax).
SEQUENCE = [
    ([5, 6, 7], 6, "acme", "fast"),
    ([8, 9], 1, "acme", "lax"),
    (list(range(3, 33)), 4, "globex", "lax"),
    ([11, 12, 13, 14], 5, "globex", "fast"),
    ([15, 16], 3, "initech", ""),
    ([17], 2, "", "gold"),
]
SHED = ([20, 21], 4, "umbrella", "fast")


async def run(batcher, reference: bool):
    """Queue the sequence before the loop starts (one admission round);
    one more submit past max_pending is shed. Returns the outputs."""
    greedy = JSampling() if reference else SamplingConfig()
    overloaded = JOverloaded if reference else OverloadedError
    its = [batcher.submit(p, n, greedy, seed=i, tenant=t, qos_class=q)
           for i, (p, n, t, q) in enumerate(SEQUENCE)]
    p, n, t, q = SHED
    with pytest.raises(overloaded):
        batcher.submit(p, n, greedy, tenant=t, qos_class=q)

    async def drain(it):
        out, reason = [], None
        async for ids, reason in it:
            out.extend(ids)
        return out, reason

    batcher.start()
    try:
        return await asyncio.gather(*(drain(it) for it in its))
    finally:
        await batcher.stop()


def _classes(stats):
    return {c["name"]: (c["met"], c["violated"], c["unevaluated"],
                        c["sheds"], c["total_requests"])
            for c in stats["slo_classes"]}


def _tenants(stats):
    return {t["tenant"]: (t["prompt_tokens"], t["decode_tokens"],
                          t["weighted_tokens"], t["admitted"], t["shed"],
                          t["finished"], t["requests"])
            for t in stats["tenants"]}


async def test_slo_and_tenant_totals_match_reference(engines):  # noqa: F811
    jeng, teng = engines
    jb = JBatcher(serving_view(jeng, slo=JSlo(default_class="lax",
                                              classes=CLASSES)),
                  JBatching(**CFG))
    ref = await run(jb, reference=True)
    tb = ContinuousBatcher(serving_view(teng, slo=SloConfig(
        default_class="lax", classes=CLASSES)), BatchingConfig(**CFG))
    out = await run(tb, reference=False)
    assert out == ref
    stats, ref_stats = tb.stats(), jb.stats()
    assert _classes(stats) == _classes(ref_stats)
    for key in ("slo_met_total", "slo_violated_total",
                "slo_unevaluated_total"):
        assert stats[key] == ref_stats[key], key
    assert _tenants(stats) == _tenants(ref_stats)
    # Both partitions fill, and the shed lands unevaluated.
    fast, lax = _classes(stats)["fast"], _classes(stats)["lax"]
    assert fast[:3] == (0, 2, 1) and lax[:3] == (4, 0, 0)
    assert stats["slo_met_total"] + stats["slo_violated_total"] + stats[
        "slo_unevaluated_total"] == len(SEQUENCE) + 1
    # The request records carry the verdict.
    _, recs = tb.flight_snapshot()
    assert sorted(r.slo_violated for r in recs) == [False] * 4 + [True] * 2


def test_overloaded_carries_the_class_backoff(engines):  # noqa: F811
    """A submit-time shed advertises the class's Retry-After (the
    scheduler config's ladder, which holds with the scheduler off)."""
    _, teng = engines
    tb = ContinuousBatcher(
        serving_view(teng, scheduler=SchedulerConfig(
            retry_after_base_s=2.0, retry_after_factor=3.0)),
        BatchingConfig(max_batch_size=1, kv_cache_max_seq=64,
                       max_pending=1))
    tb.submit([5], 2, SamplingConfig())
    waits = {}
    for qos in ("interactive", "batch", "background", "nope"):
        with pytest.raises(OverloadedError) as err:
            tb.submit([5], 2, SamplingConfig(), qos_class=qos)
        waits[qos] = err.value.retry_after_s
    assert waits == {"interactive": 2.0, "batch": 6.0, "background": 18.0,
                     "nope": 18.0}


class _Ctx:
    def __init__(self, md):
        self._md = list(md.items())

    def invocation_metadata(self):
        return self._md


# The cases of tests/test_slo_accounting.py::TestIdentityPrecedence:
# (request fields, metadata, expected tenant, expected class or None).
PRECEDENCE = {
    "explicit_fields_win": (
        {"tenant_id": "explicit", "qos_class": "fast"},
        {"x-tenant-id": "header", "x-qos-class": "lax"}, "explicit", "fast"),
    "header_beats_adapter": (
        {"adapter": "my-lora"}, {"x-tenant-id": "header"}, "header", None),
    "adapter_beats_adapter_header": (
        {"adapter": "my-lora"}, {"x-adapter-id": "other"}, "my-lora", None),
    "adapter_header_beats_session": (
        {}, {"x-adapter-id": "ad", "x-session-id": "sess"}, "ad", None),
    "session_fallback": ({}, {"x-session-id": "sess"}, "sess", ""),
    "default": ({}, {}, "default", None),
}


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_identity_precedence(case):
    fields, md, tenant, qos = PRECEDENCE[case]
    got = Sidecar._tenant_identity(serving_pb2.GenerateRequest(**fields),
                                   _Ctx(md))
    assert got[0] == tenant
    if qos is not None:
        assert got[1] == qos


async def test_identity_over_grpc_reaches_the_records():
    """Through the port's sidecar over gRPC: the request's fields win
    over the x-tenant-id / x-qos-class metadata, which win over the
    fallbacks; the flight records and the tenant table carry them."""
    side = Sidecar(ServingConfig(
        batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=64)),
        device="cpu")
    port = await side.start(0)
    calls = [  # (fields, metadata, tenant, class)
        ({"tenant_id": "explicit", "qos_class": "batch"},
         (("x-tenant-id", "header"), ("x-qos-class", "interactive")),
         "explicit", "batch"),
        ({}, (("x-tenant-id", "header"), ("x-qos-class", "background")),
         "header", "background"),
        ({}, (("x-session-id", "sess"),), "sess", ""),
        ({}, (), "default", ""),
    ]
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            gen = ch.unary_unary(
                "/ggrmcp.tpu.GenerateService/Generate",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateResponse
                .FromString)
            for i, (fields, md, _, _) in enumerate(calls):
                await gen(serving_pb2.GenerateRequest(
                    prompt="who am i", max_new_tokens=2, **fields),
                    metadata=md + (("x-trace-id", f"id-{i}"),))
        _, recs = side.batcher.flight_snapshot()
        got = {r.trace_id: (r.tenant, r.qos_class) for r in recs}
        assert got == {f"id-{i}": (t, q)
                       for i, (_, _, t, q) in enumerate(calls)}
        tenants = {t["tenant"] for t in side.batcher.stats()["tenants"]}
        assert tenants == {"explicit", "header", "sess", "default"}
    finally:
        await side.stop()
