"""Disaggregated prefill / decode (serving.role, TransferKV) in the port
against the JAX package's, held to `tests/test_disagg.py`: the same
tiny-llama weights, float32, greedy.

- Batcher level: pages exported by a prefill batcher and imported into
  a decode batcher land bit for bit; the decode replica's admission
  skips every imported full page and its tokens equal a one-replica
  run's and the JAX batcher's; the near-limit clamp; typed errors; int8
  pages ship about half the bytes.
- Across the packages: pages the JAX batcher exported import into the
  port and the reverse, over the wire codec too, and decode to the JAX
  one-replica greedy tokens.
- End to end over real gRPC with the unchanged gateway's discovery and
  role-aware router in front of port prefill / decode / mixed sidecars:
  roles at discovery, the two-leg call skipping prefill with the mixed
  replica's tokens, short prompts never on the prefill replica, the
  streaming leg, `kv_transfer_fail` (ABORTED, retried on mixed), a
  page-size mismatch (INVALID_ARGUMENT, fallback), the raw RPC; and a
  JAX prefill sidecar shipping to a port decode sidecar and back.
"""

import asyncio
import contextlib

import grpc
import grpc.aio
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import GRPCConfig, MeshConfig, RoutingConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.rpc.discovery import ServiceDiscoverer
from ggrmcp_tpu.serving import tensors as jtensors
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    ServingConfig,
    serving_config_from_dict,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import tensors
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, KVTransferError
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.pages import PageExhaustedError
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import failpoints
from tests.test_torch_observability import engines  # noqa: F401
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
GEN_TOOL = "ggrmcp_tpu_generateservice_generate"
STREAM_TOOL = "ggrmcp_tpu_generateservice_generatestream"
LONG_PROMPT = "the quick brown fox jumps over the lazy dog " * 4  # 176 B
GEN_ARGS = {"prompt": LONG_PROMPT, "maxNewTokens": 8, "returnTokens": True}


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    jfail.registry.disarm()
    yield
    failpoints.registry.disarm()
    jfail.registry.disarm()


def paged_cfg(**kw) -> dict:
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("paged_kv", "on")
    kw.setdefault("paged_kv_page_size", 8)
    return kw


def prompt_of(n: int, salt: int = 0) -> list[int]:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


async def collect(batcher, prompt, max_new, reference=False):
    out, reason = [], None
    greedy = JSampling(temperature=0.0) if reference else SamplingConfig()
    async for ids, reason in batcher.submit(prompt, max_new, greedy):
        out.extend(ids)
    return out, reason


@contextlib.asynccontextmanager
async def running(*batchers):
    for b in batchers:
        b.start()
    try:
        yield batchers
    finally:
        for b in batchers:
            await b.stop()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


async def _ship(src, dst, prompt, to_numpy=False):
    export = await src.run_host_op(lambda: src.export_prompt_kv(prompt))
    conv = _np if to_numpy else (lambda x: x)
    imported, present = await dst.run_host_op(lambda: dst.import_prompt_kv(
        prompt, 0, conv(export["k"]), conv(export["v"]),
        None if export.get("k_scale") is None else conv(export["k_scale"]),
        None if export.get("v_scale") is None else conv(export["v_scale"]),
    ))
    return export, imported, present


@pytest.mark.parametrize("n_prompt", [50, 140])
async def test_shipped_pages_land_bit_identical_and_decode(engines, n_prompt):  # noqa: F811
    """Prefill on A, decode on B over the shipped pages: the pages in
    B's arena equal A's bit for bit; B's admission reuses every full
    page below the reuse cap; its tokens equal a mixed replica's and the
    JAX batcher's. 50 tokens ride fused admission, 140 the chunked
    grid."""
    jeng, teng = engines
    prompt = prompt_of(n_prompt, salt=n_prompt)
    cfg = BatchingConfig(**paged_cfg(prefill_chunk=64))
    a, b, m = (ContinuousBatcher(teng, cfg) for _ in range(3))
    async with running(a, b, m):
        assert len((await collect(a, prompt, 1))[0]) == 1
        export, imported, present = await _ship(a, b, prompt)
        assert export["pages"] == len(prompt) // 8
        assert imported == export["pages"] and present == 0
        placed = b.pages.chain_pages(prompt)
        again = b._gather_pages(placed)
        for name in ("k", "v"):
            assert torch.equal(again[name], export[name])
        out_b = await collect(b, prompt, 12)
        out_m = await collect(m, prompt, 12)
        assert out_b == out_m
        assert b.pages.pages_reused >= export["pages"] - 1
        assert b.pages.hits == 1
    jm = JBatcher(jeng, JBatching(**paged_cfg(prefill_chunk=64)))
    async with running(jm):
        assert out_b == await collect(jm, prompt, 12, reference=True)


async def test_near_limit_prompt_clamps_consistently(engines):  # noqa: F811
    jeng, teng = engines
    prompt, max_new = prompt_of(300, salt=5), 12
    cfg = BatchingConfig(**paged_cfg())
    a, b, m = (ContinuousBatcher(teng, cfg) for _ in range(3))
    ref = JBatcher(jeng, JBatching(**paged_cfg()))
    async with running(a, b, m):
        clamped = a.clamp_prompt(prompt, max_new)
        assert clamped == prompt[-(256 - max_new - 1):]
        assert clamped == ref.clamp_prompt(prompt, max_new)
        await collect(a, clamped, 1)
        export, imported, _ = await _ship(a, b, clamped)
        assert imported == export["pages"] > 0
        out_b, _ = await collect(b, prompt, max_new)
        out_m, _ = await collect(m, prompt, max_new)
        assert out_b == out_m
        assert b.pages.pages_reused >= export["pages"] - 1


async def test_typed_errors(engines):  # noqa: F811
    _, teng = engines
    flat = ContinuousBatcher(teng, BatchingConfig(max_batch_size=2,
                                                  kv_cache_max_seq=256))
    paged = ContinuousBatcher(teng, BatchingConfig(**paged_cfg()))
    cfg = teng.cfg
    async with running(flat, paged):
        with pytest.raises(KVTransferError, match="paged_kv"):
            await flat.run_host_op(lambda: flat.export_prompt_kv(prompt_of(32)))
        with pytest.raises(KVTransferError, match="no indexed pages"):
            await paged.run_host_op(
                lambda: paged.export_prompt_kv(prompt_of(32)))
        bad = np.zeros((cfg.num_layers, 2, 4, cfg.num_kv_heads,
                        cfg.head_dim), np.float32)
        with pytest.raises(KVTransferError, match="geometry"):
            await paged.run_host_op(
                lambda: paged.import_prompt_kv(prompt_of(16), 0, bad, bad))
        good = np.zeros((cfg.num_layers, 2, 8, cfg.num_kv_heads,
                         cfg.head_dim), np.float32)
        scale = np.zeros(good.shape[:-1] + (1,), np.float32)
        with pytest.raises(KVTransferError, match="dtype"):
            await paged.run_host_op(lambda: paged.import_prompt_kv(
                prompt_of(16), 0, good, good, scale, scale))
        with pytest.raises(ValueError, match="outside the prompt"):
            await paged.run_host_op(
                lambda: paged.import_prompt_kv(prompt_of(10), 0, good, good))
    tiny = ContinuousBatcher(teng, BatchingConfig(**paged_cfg(
        max_batch_size=1, paged_kv_pages=1, kv_cache_max_seq=64)))
    async with running(tiny):
        with pytest.raises(PageExhaustedError):
            await tiny.run_host_op(
                lambda: tiny.import_prompt_kv(prompt_of(16), 0, good, good))
    with pytest.raises(RuntimeError, match="not running"):
        await tiny.run_host_op(lambda: None)


async def test_stop_fails_queued_host_ops_loudly(engines):  # noqa: F811
    _, teng = engines
    batcher = ContinuousBatcher(teng, BatchingConfig(**paged_cfg()))
    batcher.start()
    loop = asyncio.get_running_loop()
    fut = loop.create_future()
    batcher._host_ops.append((lambda: 1, fut))
    await batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        await fut


async def test_int8_pages_ship_half_the_bytes(engines):  # noqa: F811
    jeng, teng = engines
    eng8 = GenerationEngine(tl.CONFIGS["tiny-llama"],
                            ServingConfig(kv_cache_dtype="int8"),
                            params=teng.params, device="cpu")
    prompt = prompt_of(50, salt=9)
    cfg = BatchingConfig(**paged_cfg())
    a, b, m = (ContinuousBatcher(eng8, cfg) for _ in range(3))
    f32 = ContinuousBatcher(teng, cfg)
    async with running(a, b, m, f32):
        await collect(a, prompt, 1)
        export, imported, _ = await _ship(a, b, prompt)
        assert export["k"].dtype == torch.int8 and "k_scale" in export
        assert imported == export["pages"]
        assert await collect(b, prompt, 10) == await collect(m, prompt, 10)
        await collect(f32, prompt, 1)
        full = await f32.run_host_op(lambda: f32.export_prompt_kv(prompt))
    wire8 = len(tensors.pack_kv_pages(export["k"], export["v"],
                                      export["k_scale"], export["v_scale"]))
    wire32 = len(tensors.pack_kv_pages(full["k"], full["v"]))
    assert wire8 < 0.3 * wire32  # int8 values + scales vs float32


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
async def test_pages_cross_the_packages(engines, direction):  # noqa: F811
    """Pages exported by one package import into the other's arena (as
    arrays and through the wire codec) and decode to the JAX one-replica
    greedy tokens."""
    jeng, teng = engines
    prompt = prompt_of(60, salt=3)
    jcfg, cfg = JBatching(**paged_cfg()), BatchingConfig(**paged_cfg())
    jm = JBatcher(jeng, jcfg)
    async with running(jm):
        want = await collect(jm, prompt, 10, reference=True)
    if direction == "reference_to_port":
        src, dst = JBatcher(jeng, jcfg), ContinuousBatcher(teng, cfg)
        wire_in = tensors
    else:
        src, dst = ContinuousBatcher(teng, cfg), JBatcher(jeng, jcfg)
        wire_in = jtensors
    wire_out = jtensors if direction == "reference_to_port" else tensors
    async with running(src, dst):
        await collect(src, prompt, 1, reference=isinstance(src, JBatcher))
        export = await src.run_host_op(lambda: src.export_prompt_kv(prompt))
        blob = wire_out.pack_kv_pages(export["k"], export["v"])
        k, v, _, _ = wire_in.unpack_kv_pages(blob)
        imported, _ = await dst.run_host_op(
            lambda: dst.import_prompt_kv(prompt, 0, k, v))
        assert imported == export["pages"] == len(prompt) // 8
        got = await collect(dst, prompt, 10,
                            reference=isinstance(dst, JBatcher))
        reused = (dst.pages.pages_reused)
    assert got == want
    assert reused >= imported - 1


# -- sidecars over gRPC --------------------------------------------------------


@pytest.fixture(scope="module")
def side_params():
    """One weight set (the JAX engine's init) for every sidecar here."""
    from ggrmcp_tpu.models import llama as jl

    jparams = jl.init_params(jax.random.PRNGKey(0), jl.CONFIGS["tiny-llama"])
    return jparams, jax.tree.map(np.asarray, jparams)


def sidecar_cfg(role: str, page: int = 8) -> ServingConfig:
    return serving_config_from_dict({"serving": {
        "model": "tiny-llama", "role": role,
        "batching": paged_cfg(paged_kv_page_size=page)}})


def port_sidecar(side_params, role: str, page: int = 8) -> Sidecar:
    return Sidecar(sidecar_cfg(role, page),
                   params=params_from_numpy(side_params[1], CPU),
                   device="cpu")


@contextlib.asynccontextmanager
async def disagg_env(side_params, sides=None):
    """Port prefill + decode + mixed sidecars behind one discoverer (the
    gateway's), roles stamped at discovery."""
    sides = sides or [port_sidecar(side_params, r)
                      for r in ("prefill", "decode", "mixed")]
    for side in sides:
        await side.start(0)
    disc = ServiceDiscoverer(
        [s.target for s in sides], GRPCConfig(connect_timeout_s=5.0),
        routing=RoutingConfig(disagg_min_prompt_tokens=64),
    )
    await disc.connect()
    await disc.discover_services()
    try:
        yield sides, disc
    finally:
        await disc.close()
        for side in sides:
            await side.stop()


async def test_two_leg_call_skips_prefill(side_params):
    async with disagg_env(side_params) as ((p, d, m), disc):
        roles = {b.target: b.role for b in disc.backends}
        assert roles == {p.target: "prefill", d.target: "decode",
                         m.target: "mixed"}
        result = await disc.invoke_by_tool(GEN_TOOL, dict(GEN_ARGS))
        snap = disc.get_routing_stats()["backends"]
        assert snap[p.target]["disagg_prefills"] == 1
        assert snap[d.target]["disagg_decodes"] == 1
        assert d.batcher.pages.pages_reused > 0
        p_stats = await p.get_serving_stats(None, None)
        d_stats = await d.get_serving_stats(None, None)
        assert p_stats.role == "prefill" and d_stats.role == "decode"
        assert p_stats.kv_transfers_sent == 1
        assert p_stats.kv_transfer_pages_sent > 0
        assert d_stats.kv_transfers_received == 1
        assert d_stats.kv_transfer_bytes_received == (
            p_stats.kv_transfer_bytes_sent)
        assert d_stats.kv_transfer_pages_received == (
            p_stats.kv_transfer_pages_sent)
        mixed = await disc.backends[2].invoker.invoke(
            disc.get_method_by_tool(GEN_TOOL), dict(GEN_ARGS), None, 30.0)
        assert result["tokenIds"] == mixed["tokenIds"]
        # Short prompts never land on the prefill replica.
        picks = snap[p.target]["routing_picks"]
        for i in range(4):
            await disc.invoke_by_tool(GEN_TOOL, {"prompt": f"hi {i}",
                                                 "maxNewTokens": 2})
        snap = disc.get_routing_stats()["backends"]
        assert snap[p.target]["disagg_prefills"] == 1
        assert snap[p.target]["routing_picks"] == picks
        # The streaming call takes the two legs too.
        chunks = [c async for c in disc.invoke_stream_by_tool(
            STREAM_TOOL, dict(GEN_ARGS))]
        assert chunks and chunks[-1].get("done")
        snap = disc.get_routing_stats()["backends"]
        assert snap[p.target]["disagg_prefills"] == 2


async def test_transfer_failure_retries_typed_on_mixed(side_params):
    async with disagg_env(side_params) as ((p, _d, m), disc):
        baseline = await disc.invoke_by_tool(GEN_TOOL, dict(GEN_ARGS))
        failpoints.registry.arm("kv_transfer_fail", every=1, times=1)
        retried = await disc.invoke_by_tool(GEN_TOOL, dict(GEN_ARGS))
        failpoints.registry.disarm()
        assert retried["tokenIds"] == baseline["tokenIds"]
        snap = disc.get_routing_stats()["backends"]
        assert snap[m.target]["disagg_fallbacks"] == 1
        assert (await p.get_serving_stats(None, None)).kv_transfer_failures == 1


async def test_page_size_mismatch_rejected_typed(side_params):
    sides = [port_sidecar(side_params, "prefill"),
             port_sidecar(side_params, "decode", page=16),
             port_sidecar(side_params, "mixed")]
    async with disagg_env(side_params, sides) as ((p, _d, m), disc):
        result = await disc.invoke_by_tool(GEN_TOOL, dict(GEN_ARGS))
        assert result.get("tokenIds")
        snap = disc.get_routing_stats()["backends"]
        assert snap[m.target].get("disagg_fallbacks", 0) == 1
        assert (await p.get_serving_stats(None, None)).kv_transfer_failures == 1


def _stub(target, method, req, resp):
    channel = grpc.aio.insecure_channel(target)
    return channel, channel.unary_unary(
        method, request_serializer=req.SerializeToString,
        response_deserializer=resp.FromString)


async def test_direct_rpc_transfer_round_trip(side_params):
    """Generate with kv_transfer_target answers "transferred" and the
    peer's import shows in its stats; a direct TransferKV with the wrong
    page size is INVALID_ARGUMENT."""
    p = port_sidecar(side_params, "prefill")
    d = port_sidecar(side_params, "decode")
    await p.start(0)
    await d.start(0)
    ch, gen = _stub(p.target, "/ggrmcp.tpu.GenerateService/Generate",
                    serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
    ch2, xfer = _stub(d.target, "/ggrmcp.tpu.KVTransferService/TransferKV",
                      serving_pb2.KVTransferRequest,
                      serving_pb2.KVTransferResponse)
    try:
        resp = await gen(serving_pb2.GenerateRequest(
            prompt=LONG_PROMPT, max_new_tokens=8,
            kv_transfer_target=d.target), timeout=60)
        assert resp.finish_reason == "transferred"
        assert not resp.text and not resp.token_ids
        d_stats = await d.get_serving_stats(None, None)
        assert d_stats.kv_transfers_received == 1
        assert d_stats.kv_transfer_pages_received > 0
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await xfer(serving_pb2.KVTransferRequest(prompt_ids=[1] * 16,
                                                     page_size=16))
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await xfer(serving_pb2.KVTransferRequest(
                prompt_ids=[1] * 16, page_size=8, kv_dtype="int8"))
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        await ch.close()
        await ch2.close()
        await p.stop()
        await d.stop()


@pytest.mark.parametrize("prefill_side", ["reference", "port"])
async def test_cross_package_sidecars_ship_to_each_other(side_params,
                                                         prefill_side):
    """A JAX prefill sidecar ships to a port decode sidecar (and the
    reverse) over TransferKV; the decode replica's tokens equal a JAX
    mixed sidecar's for the same request."""
    jparams, _ = side_params

    from ggrmcp_tpu.parallel import mesh as mesh_mod

    def jside(role):
        side = JSidecar(JServing(
            mesh=MeshConfig(tensor=1), role=role,
            batching=JBatching(**paged_cfg())),
            mesh=mesh_mod.build_mesh(MeshConfig(tensor=1),
                                     jax.devices()[:1]))
        side.generation.params = jparams
        return side

    mixed = jside("mixed")
    if prefill_side == "reference":
        p, d = jside("prefill"), port_sidecar(side_params, "decode")
    else:
        p, d = port_sidecar(side_params, "prefill"), jside("decode")
    for side in (mixed, p, d):
        await side.start(0)
    req = dict(prompt=LONG_PROMPT, max_new_tokens=8, return_tokens=True)
    chans = []
    try:
        calls = {}
        for name, side in (("p", p), ("d", d), ("m", mixed)):
            ch, calls[name] = _stub(
                side.target, "/ggrmcp.tpu.GenerateService/Generate",
                serving_pb2.GenerateRequest, serving_pb2.GenerateResponse)
            chans.append(ch)
        leg1 = await calls["p"](serving_pb2.GenerateRequest(
            kv_transfer_target=d.target, **req), timeout=60)
        assert leg1.finish_reason == "transferred"
        got = await calls["d"](serving_pb2.GenerateRequest(**req), timeout=60)
        want = await calls["m"](serving_pb2.GenerateRequest(**req),
                                timeout=60)
        assert list(got.token_ids) == list(want.token_ids)
        assert d.batcher.pages.pages_reused > 0
    finally:
        for ch in chans:
            await ch.close()
        for side in (mixed, p, d):
            await side.stop()


def test_role_checks_match_reference():
    from ggrmcp_tpu.core.config import Config

    for role, batching, match in (
        ("primary", {}, "unknown serving.role"),
        ("prefill", {}, "paged_kv"),
        ("decode", {"paged_kv": "on", "kv_tiers": [[128, 2]]}, "kv_tiers"),
    ):
        cfg = Config()
        cfg.serving.role = role
        for key, value in batching.items():
            setattr(cfg.serving.batching, key, value)
        with pytest.raises(ValueError, match=match):
            cfg.validate()
        with pytest.raises(ValueError, match=match):
            # The reference's role check, naming the field.
            ServingConfig(role=role, batching=BatchingConfig(**batching))
    assert sidecar_cfg("decode").role == "decode"
    cfg = ServingConfig()
    cfg.role = "prefill"  # past the config's own check
    with pytest.raises(ValueError, match="paged_kv"):
        Sidecar(cfg, device="cpu")
