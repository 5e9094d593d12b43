"""Expert parallelism in the port: tiny-moe in float32 at expert=2 x
tensor=2 (four shards on the CPU) against the JAX package at the same
mesh over `jax.devices()[:4]`, both from one host weight tree crossed
through numpy.

Tolerances, as in tests/test_torch_moe.py: routing decisions (the
experts, the slots, the drops) exact; logits and the FFN's output within
2e-4 (float32 sums in another order: the expert outputs are summed over
shards). Greedy tokens through the batcher equal the reference's and the
port's one-device run's.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import common as tcommon
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

ATOL = 2e-4
CPU = torch.device("cpu")
NAME = "tiny-moe"
CFG = tm.CONFIGS[NAME]
# Binding capacity, so that the sharded FFN must drop the same pairs.
TIGHT = 0.5
WAVE = [[5, 6, 7, 9, 11], [13, 3, 44, 210, 87, 6],
        [3 + (i * 11 % 490) for i in range(40)]]


def _cross(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.PRNGKey(0), jm.CONFIGS[NAME])


@pytest.fixture(scope="module")
def jeng(jparams):
    mesh = jmesh.build_mesh(JMesh(expert=2, tensor=2, data=1),
                            jax.devices()[:4])
    return JEngine(jm.CONFIGS[NAME], JServing(model=NAME), mesh=mesh,
                   params=jparams)


@pytest.fixture(scope="module")
def teng(jparams):
    return GenerationEngine(
        CFG, ServingConfig(model=NAME,
                           mesh=MeshConfig(expert=2, tensor=2)),
        params=_cross(jparams), device="cpu")


@pytest.fixture(scope="module")
def teng1(jparams):
    return GenerationEngine(CFG, ServingConfig(model=NAME),
                            params=_cross(jparams), device="cpu")


def test_banks_shard_over_expert_and_tensor(teng, teng1):
    assert teng.mesh_stats() == {"tp_chips": 2, "mesh_devices": 4,
                                 "mesh_shape": "tensor=2,expert=2",
                                 "mesh_spec_downgrades": 0}
    layers = teng.params["layers"]
    whole = teng1.params["layers"]
    e, f = CFG.num_experts // 2, CFG.ffn_dim // 2
    for c in range(4):
        coord = teng.mesh.coord(c)
        ex, t = coord["expert"], coord["tensor"]
        assert torch.equal(layers["w_gate"].parts[c], whole["w_gate"][
            :, ex * e:(ex + 1) * e, :, t * f:(t + 1) * f])
        assert torch.equal(layers["w_down"].parts[c], whole["w_down"][
            :, ex * e:(ex + 1) * e, t * f:(t + 1) * f])
        assert torch.equal(layers["router"].parts[c], whole["router"])
    # Attention is tensor-parallel only: the expert replicas share it.
    wqkv = layers["wqkv"]
    assert wqkv.parts[teng.mesh.index(expert=1, tensor=0)] is wqkv.parts[0]


def test_mesh_stats_match_reference(jeng, teng):
    assert teng.mesh_stats() == jeng.mesh_stats()
    for key in ("mesh", "num_devices", "family", "num_params_million"):
        assert teng.model_info()[key] == jeng.model_info()[key]


def test_routing_exact_and_ffn_close_to_reference(jeng, teng, monkeypatch):
    """One layer's FFN at a binding capacity: the port routes once on the
    replicated activations; the experts, slots and drops equal the
    reference's route on the mesh, and the summed shards' output its
    moe_ffn's."""
    cfg = dataclasses.replace(CFG, capacity_factor=TIGHT)
    jcfg = dataclasses.replace(jm.CONFIGS[NAME], capacity_factor=TIGHT)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, CFG.hidden_dim)).astype(np.float32)
    valid = np.ones((2, 12), bool)
    valid[1, 9:] = False
    seen = []
    real = tm._assign

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args[0], out))
        return out

    monkeypatch.setattr(tm, "_assign", spy)
    x_in = tcommon.rms_norm(torch.from_numpy(x),
                            torch.ones(CFG.hidden_dim), cfg.norm_eps)
    out = tm.moe_ffn_sharded([x_in], teng.params["layers"], 0, cfg,
                             torch.from_numpy(valid))[0][CPU]
    (routed_x, (_, topk_p, topk_i, slot, kept)), = seen
    assert torch.equal(routed_x, x_in.reshape(-1, CFG.hidden_dim))
    cap = tm._capacity(cfg, 24)
    assert int((~kept & torch.from_numpy(valid).reshape(-1, 1)).sum()) > 0
    disp = F.one_hot(topk_i, cfg.num_experts).float() * kept[..., None]
    slot_oh = F.one_hot(torch.clamp(slot, max=cap - 1), cap).float()
    dispatch = torch.einsum("tke,tkc->tec", disp, slot_oh)

    jl0 = jax.tree.map(lambda a: a[0], jeng.params["layers"])
    with jeng.mesh:
        jdisp, _, _ = jax.jit(
            lambda xx, r, v: jm.route(xx, r, jcfg, cap, v)
        )(routed_x.numpy(), jl0["router"], valid.reshape(-1))
        jout, _ = jax.jit(
            lambda xx, lp, v: jm.moe_ffn(xx, lp, jcfg, v)
        )(x_in.numpy(), jl0, valid)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdisp))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)


def test_logits_match_reference_and_one_device(jeng, teng, teng1):
    tokens = np.random.default_rng(0).integers(3, 500, (2, 24)).astype(
        np.int32)
    step = np.array([[17], [29]], np.int32)
    with jeng.mesh:
        jlog, cache = jax.jit(jeng.prefill_forward)(
            jeng.params, tokens, jeng.make_cache(2, 64))
        jnxt, _ = jax.jit(jeng.decode_forward)(jeng.params, step, cache)

    def trun(eng):
        cache = eng.make_cache(2, 64)
        logits, cache = eng.prefill_forward(eng.params,
                                            torch.from_numpy(tokens), cache)
        nxt, _ = eng.decode_forward(eng.params, torch.from_numpy(step), cache)
        return logits.numpy(), nxt.numpy()

    for eng in (teng, teng1):
        got = trun(eng)
        np.testing.assert_allclose(got[0], np.asarray(jlog), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got[1], np.asarray(jnxt), atol=ATOL,
                                   rtol=0)
    assert isinstance(teng.make_cache(2, 8).k, Sharded)


def _wave(engine, jax_side):
    cls, bcls = ((JBatcher, JBatching) if jax_side
                 else (ContinuousBatcher, BatchingConfig))
    greedy = JSampling() if jax_side else SamplingConfig()
    batcher = cls(engine, bcls(max_batch_size=4, kv_cache_max_seq=128,
                               prefill_chunk=32, max_queue_delay_ms=1000.0))

    async def go():
        its = [batcher.submit(p, 6, greedy, seed=i)
               for i, p in enumerate(WAVE)]
        batcher.start()
        try:
            outs = []
            for it in its:
                toks = []
                async for ids, _ in it:
                    toks.extend(ids)
                outs.append(toks)
            return outs
        finally:
            await batcher.stop()

    return asyncio.run(go())


def test_batcher_tokens_match_reference_and_one_device(jeng, teng, teng1):
    want = _wave(jeng, True)
    assert _wave(teng, False) == want
    assert _wave(teng1, False) == want
