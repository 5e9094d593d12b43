"""Data-parallel serving in the port: the `data` and `fsdp` axes, alone
and with `tensor` and `stage`, against the JAX package's engine and
batcher on the same meshes (`jax.devices()[:n]` of the suite's forced
8-device CPU platform; the port's mesh is the CPU repeated), tiny-llama
in float32 from ONE host weight tree crossed through numpy.

What is held:
- logits of a prefill and a cached decode step within atol 1e-5 /
  rtol 1e-4 of the JAX engine's on the same mesh, at data=2, fsdp=2,
  data=2 x tensor=2 and stage=2 x tensor=2 x data=2;
- the attention runs once per (data block x tensor shard) on that
  block's rows and that shard's heads (the kernel's launches on the
  card, its plain version here), and once per tensor shard on a batch
  the data blocks do not divide;
- greedy tokens through the batcher identical to the JAX batcher's
  (data=2 mesh) on every mesh, and through the paged, prefix, interleave
  and speculative routes equal to data=1's; sampled rows drawn alike
  (a slot's key folds its global row, whatever its block);
- tiny-moe at data=2 x expert=2 routes pair for pair as data=1 and as
  the JAX `route`, and its logits match the JAX engine's;
- the mesh identity on the wire in the reference's values and formats,
  from a `--config` file naming data=2 x tensor=2; the memory ledger
  reconciled, the replicated weights counted once;
- data blocks on distinct devices refused for serving (the multi-card
  row exchange, ROADMAP A18b item 3).
"""

import asyncio
import dataclasses
import json

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    MeshConfig,
    ServingConfig,
    load_serving_config,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")
NAME = "tiny-llama"
CFG, JCFG = tl.CONFIGS[NAME], jl.CONFIGS[NAME]
MESH_KEYS = ("tp_chips", "mesh_devices", "mesh_shape",
             "mesh_spec_downgrades")
MESHES = {
    "data2": dict(data=2),
    "fsdp2": dict(fsdp=2),
    "data2_tensor2": dict(data=2, tensor=2),
    "stage2_tensor2_data2": dict(stage=2, tensor=2, data=2),
}

PRE = [3 + (i * 11 % 490) for i in range(24)]
WAVE = [[5, 6, 7, 9, 11], [13, 3, 44, 210, 87, 6], PRE + [7, 8, 9],
        PRE + [30, 31], [3 + (i * 7 % 500) for i in range(80)]]


def _full(axes):
    return {"data": 1, "tensor": 1, **axes}


def _n(axes):
    return int(np.prod(list(axes.values())))


def _jmesh(axes):
    return jmesh.build_mesh(JMesh(**_full(axes)), jax.devices()[:_n(axes)])


def _tmesh(axes):
    return tmesh.build_mesh(MeshConfig(**_full(axes)), [CPU] * _n(axes))


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(7), JCFG)


@pytest.fixture(scope="module")
def host(jparams):
    return jax.tree.map(np.asarray, jparams)


def _engine(host, axes, cfg=CFG, **serving):
    return GenerationEngine(
        cfg, ServingConfig(mesh=MeshConfig(**_full(axes)), **serving),
        params=params_from_numpy(host, CPU), mesh=_tmesh(axes))


def _bcfg(cls, **kw):
    kw.setdefault("max_queue_delay_ms", 1000.0)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 128)
    kw.setdefault("prefill_chunk", 32)
    return cls(**kw)


async def _consume(it):
    out = []
    async for ids, _ in it:
        out.extend(ids)
    return out


def _wave(engine, prompts=WAVE, max_new=6, sampling=None, **kw):
    jax_side = isinstance(engine, JEngine)
    batcher = (JBatcher(engine, _bcfg(JBatching, **kw)) if jax_side
               else ContinuousBatcher(engine, _bcfg(BatchingConfig, **kw)))
    sampling = sampling or (JSampling() if jax_side else SamplingConfig())

    async def go():
        its = [batcher.submit(p, max_new, sampling, seed=i)
               for i, p in enumerate(prompts)]
        batcher.start()
        try:
            return await asyncio.gather(*(_consume(it) for it in its))
        finally:
            await batcher.stop()

    return asyncio.run(go()), batcher


@pytest.fixture(scope="module")
def jeng_d2(jparams):
    return JEngine(JCFG, JServing(), mesh=_jmesh(dict(data=2)),
                   params=jparams)


@pytest.fixture(scope="module")
def wave_ref(jeng_d2):
    return _wave(jeng_d2)[0]


# -- logits and the per-block attention ----------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_logits_match_reference_on_the_mesh(jparams, host, name):
    axes = MESHES[name]
    jeng = JEngine(JCFG, JServing(), mesh=_jmesh(axes), params=jparams)
    tokens = np.random.default_rng(0).integers(3, 500, (4, 40)).astype(
        np.int32)
    step = np.array([[17], [29], [31], [37]], np.int32)
    with jeng.mesh:
        logits, cache = jax.jit(jeng.prefill_forward)(
            jeng.params, tokens, jeng.make_cache(4, 64))
        nxt, _ = jax.jit(jeng.decode_forward)(jeng.params, step, cache)
    teng = _engine(host, axes)
    tcache = teng.make_cache(4, 64)
    assert isinstance(tcache.k, Sharded)
    assert tcache.k.factors[1] == tmesh.data_size(teng.mesh) == 2
    got, tcache = teng.prefill_forward(teng.params, torch.from_numpy(tokens),
                                       tcache)
    got_n, _ = teng.decode_forward(teng.params, torch.from_numpy(step),
                                   tcache)
    for g, w in ((got, logits), (got_n, nxt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    assert teng.mesh_stats()["mesh_spec_downgrades"] == 0


@pytest.mark.parametrize("name,batch,blocks", [
    ("data2", 4, 2), ("data2_tensor2", 4, 2), ("data2", 3, 1),
], ids=["data2", "data2_tensor2", "unsplit"])
def test_attention_runs_per_data_block_and_tensor_shard(
        host, monkeypatch, name, batch, blocks):
    """A [B, 40] prefill calls the kernel's entry once per layer, data
    block and tensor shard, each on B / data rows and H / tensor heads;
    a batch of 3 at data=2 runs as one block, the kernel's entry still
    called once per layer and tensor shard on all its rows."""
    axes = MESHES[name]
    t = axes.get("tensor", 1)
    teng = _engine(host, axes)
    shapes = []
    real = tatt.flash_attention

    def spy(q, k, v, **kw):
        shapes.append((q.shape[0], q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        3, 500, (batch, 40)).astype(np.int32))
    got, _ = teng.prefill_forward(teng.params, tokens,
                                  teng.make_cache(batch, 64))
    assert shapes == [(batch // blocks, CFG.num_heads // t,
                       CFG.num_kv_heads // t)] * (CFG.num_layers * blocks * t)
    one = _engine(host, {})
    want, _ = one.prefill_forward(one.params, tokens,
                                  one.make_cache(batch, 64))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_cache_rows_belong_to_their_data_blocks(host):
    """The contiguous cache splits by slot: a data block's part is the
    view of its slots' rows in one storage per (tensor block, device),
    which the batcher's global row moves reach."""
    teng = _engine(host, MESHES["data2_tensor2"])
    cache = teng.make_cache(4, 64)
    mesh = teng.mesh
    for c, part in enumerate(cache.k.parts):
        block = tmesh.data_block(mesh, c)
        base = cache.k.bases[c]
        assert part.shape[1] == 2
        assert part.data_ptr() == base[:, 2 * block].data_ptr()
    assert len({id(b) for b in cache.k.bases}) == 2  # one per tensor block
    assert cache.k.nbytes == sum(b.nbytes for b in {
        id(b): b for b in cache.k.bases}.values())


# -- the batcher ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_wave_matches_reference(host, wave_ref, name):
    outs, batcher = _wave(_engine(host, MESHES[name]))
    assert outs == wave_ref
    assert batcher.fused_admissions > 0 and batcher.chunked_admissions > 0


@pytest.mark.parametrize("route,serving,kw", [
    ("paged", {}, dict(paged_kv="on", paged_kv_page_size=8)),
    ("prefix", {}, dict(prefix_cache_entries=4, prefix_cache_max_seq=64)),
    ("interleave", {}, dict(prefill_interleave="on")),
    ("speculative", dict(speculative_draft=NAME), dict(speculative="on")),
    ("int8_kv", dict(kv_cache_dtype="int8"), {}),
])
def test_routes_at_data2_tensor2_match_data1(host, route, serving, kw):
    draft = {}
    if serving.get("speculative_draft"):
        draft = dict(draft_params=params_from_numpy(host, CPU))

    def engine(axes):
        return GenerationEngine(
            CFG, ServingConfig(mesh=MeshConfig(**_full(axes)), **serving),
            params=params_from_numpy(host, CPU), mesh=_tmesh(axes), **draft)

    want, _ = _wave(engine({}), **kw)
    got, batcher = _wave(engine(MESHES["data2_tensor2"]), **kw)
    assert got == want
    if route == "paged":
        assert batcher.pages.stats()["paged_prefix_hits"] >= 1
    if route == "speculative":
        assert batcher.spec_ticks >= 1


@pytest.mark.parametrize("name", ["data2", "data2_tensor2"])
def test_sampled_rows_drawn_alike(jeng_d2, host, name):
    prompts = [WAVE[1], WAVE[0], WAVE[2], WAVE[3]]
    got, _ = _wave(_engine(host, MESHES[name]), prompts, 8,
                   SamplingConfig(temperature=0.7, top_k=8))
    want, _ = _wave(jeng_d2, prompts, 8, JSampling(temperature=0.7, top_k=8))
    assert got == want


# -- MoE -----------------------------------------------------------------------


def test_moe_routes_batch_globally_at_data2():
    name = "tiny-moe"
    jcfg, cfg = jm.CONFIGS[name], tm.CONFIGS[name]
    jparams = jm.init_params(jax.random.PRNGKey(3), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(4).integers(3, 500, (4, 24)).astype(
        np.int32)
    axes = dict(data=2, expert=2)
    jeng = JEngine(jcfg, JServing(), mesh=_jmesh(axes), params=jparams)
    with jeng.mesh:
        want, _ = jax.jit(jeng.prefill_forward)(jeng.params, tokens,
                                                jeng.make_cache(4, 32))
    seen = []
    real = tm._assign

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args[0].clone(), [t.clone() for t in out[2:]]))
        return out

    routes = []
    for mesh_axes in (axes, dict(expert=2)):
        seen.clear()
        teng = _engine(host, mesh_axes, cfg)
        tm._assign = spy
        try:
            got, _ = teng.prefill_forward(teng.params,
                                          torch.from_numpy(tokens),
                                          teng.make_cache(4, 32))
        finally:
            tm._assign = real
        assert len(seen) == cfg.num_layers  # once a layer, every block
        routes.append(list(seen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    for (_, a), (_, b) in zip(*routes):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # Each layer's kept pairs against the JAX `route` on the same
    # activations and router: the same (token, expert, slot) dispatch.
    cap = tm._capacity(cfg, 4 * 24)
    for layer, (x, (topk_i, slot, kept)) in enumerate(routes[0]):
        disp = torch.nn.functional.one_hot(
            topk_i, cfg.num_experts).float() * kept[..., None]
        slot_oh = torch.nn.functional.one_hot(
            torch.clamp(slot, max=cap - 1), cap).float()
        dispatch = torch.einsum("tke,tkc->tec", disp, slot_oh)
        jdisp, _, _ = jm.route(x.numpy(), host["layers"]["router"][layer],
                               jcfg, cap)
        np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdisp))


# -- identity, memory, placement ----------------------------------------------


async def _fields(side):
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    try:
        def rpc(method, req, resp):
            return channel.unary_unary(
                method, request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString)

        gen = await rpc("/ggrmcp.tpu.GenerateService/Generate",
                        serving_pb2.GenerateRequest,
                        serving_pb2.GenerateResponse)(
            serving_pb2.GenerateRequest(prompt="the quick", max_new_tokens=4,
                                        return_tokens=True))
        stats = await rpc("/ggrmcp.tpu.ModelInfoService/GetServingStats",
                          serving_pb2.ServingStatsRequest,
                          serving_pb2.ServingStatsResponse)(
            serving_pb2.ServingStatsRequest())
        info = await rpc("/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                         serving_pb2.ModelInfoRequest,
                         serving_pb2.ModelInfoResponse)(
            serving_pb2.ModelInfoRequest())
    finally:
        await channel.close()
        await side.stop()
    return (list(gen.token_ids), {k: getattr(stats, k) for k in MESH_KEYS},
            dict(info.mesh), info.num_devices)


async def test_sidecar_from_a_config_file_matches_reference(host, tmp_path):
    """A `--config` file naming data=2 x tensor=2 serves on the CPU
    repeated; GetServingStats and GetModelInfo carry the data axis in
    the reference's formats."""
    path = tmp_path / "dp.json"
    batching = {"max_batch_size": 4, "kv_cache_max_seq": 128}
    path.write_text(json.dumps({"serving": {
        "model": NAME, "mesh": {"data": 2, "tensor": 2},
        "batching": batching}}))
    serving = load_serving_config(str(path))
    tside = Sidecar(serving, params=params_from_numpy(host, CPU),
                    device="cpu")
    jside = JSidecar(JServing(model=NAME, batching=JBatching(**batching)),
                     mesh=_jmesh(dict(data=2, tensor=2)))
    got, want = await _fields(tside), await _fields(jside)
    assert got[1:] == want[1:]
    assert got[1]["mesh_shape"] == "data=2,tensor=2"
    assert got[2] == {"data": 2, "tensor": 2} and got[3] == 4
    assert len(got[0]) > 0


def test_memory_ledger_reconciles_at_data2(host):
    """GetMemory's reconcile on data=2 x tensor=2: the replicated weights
    (one stored tensor shared by both data blocks) counted once, the
    cache's block views once: the bytes of one device's tree and pool."""
    teng = _engine(host, MESHES["data2_tensor2"])
    batcher = ContinuousBatcher(teng, _bcfg(BatchingConfig))
    one = _engine(host, {})
    ref = ContinuousBatcher(one, _bcfg(BatchingConfig))
    rec = teng.ledger.reconcile()
    assert rec["double_registered"] == 0
    assert rec["components"]["weights"] == one.weight_bytes() == (
        teng.weight_bytes())
    assert rec["components"]["kv_arena"] == one.ledger.reconcile()[
        "components"]["kv_arena"]
    assert batcher.cache_bytes() == ref.cache_bytes()


def test_data_blocks_on_distinct_devices_are_refused():
    mesh = tmesh.build_mesh(MeshConfig(data=2, tensor=1),
                            ["cpu", "meta"])
    with pytest.raises(ValueError, match="ROADMAP A18b item 3"):
        tmesh.check_data_placement(mesh)
    tmesh.check_data_placement(_tmesh(dict(data=2, tensor=2)))


def test_data_axes_infer_and_split_in_order():
    mesh = tmesh.build_mesh(MeshConfig(data=0, fsdp=2, tensor=2), [CPU] * 8)
    assert mesh.shape["data"] == 2 and tmesh.data_size(mesh) == 4
    assert tmesh.mesh_shape_str(mesh) == "data=2,fsdp=2,tensor=2"
    blocks = tmesh.data_blocks(mesh, 8)
    assert [r for r, _ in blocks] == [slice(2 * i, 2 * i + 2)
                                      for i in range(4)]
    assert [at for _, at in blocks] == [
        {"data": d, "fsdp": f} for d in range(2) for f in range(2)]
    assert [tmesh.data_block(mesh, c) for c in range(8)] == [
        0, 0, 1, 1, 2, 2, 3, 3]
    assert ServingConfig(mesh=MeshConfig(data=2, fsdp=2)).mesh.data == 2
    assert dataclasses.asdict(MeshConfig(data=2))["data"] == 2
