"""The sparse-MoE family of the port (`ggrmcp_tpu_torch/models/moe.py`)
against the JAX package's, on tiny-moe (and tiny-moe-sw for the ring) in
float32 with the same weights: the JAX init tree crossed through
`params_from_numpy`, the JAX engine on one CPU device. The reference's
own `tests/test_moe.py` is marked slow; this file is the tier-1 MoE
coverage.

Tolerances: routing decisions (dispatch, the slots, the drops) and
`_capacity` are equal exactly; the combine weights and the router
probabilities within 1e-6 (the float32 router product and softmax round
differently in XLA and in PyTorch); logits within atol 2e-4 (the llama
tests' bound: float32 sums in another order through the layers and the
vocabulary projection). Greedy tokens, and sampled tokens draw for draw,
are identical through the engine, the batcher's fused, chunked and
interleaved admissions and its decode ticks (idle slots masked), the
prefix pool, length tiers and the ring.
"""

import asyncio
import dataclasses
import json
import logging

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu.serving.tiered import TieredBatcher as JTiered
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    GrammarConfig,
    LoraConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import common as tcommon
from ggrmcp_tpu_torch.models import family_module, get_model
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.serving.tiered import TieredBatcher
from tests import torch_threads  # noqa: F401

ATOL = 2e-4
ROUTE_TOL = 1e-6
CPU = torch.device("cpu")
NAME = "tiny-moe"
CFG = tm.CONFIGS[NAME]
# A binding capacity: at 16 tokens a step each of the 4 experts holds 8
# of the 32 (token, k) pairs, so routing drops pairs and every token of
# a step competes with the others (idle slots too, unless masked).
TIGHT = 0.5


def _mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


def _cross(jparams, dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU, dtype)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.PRNGKey(0), jm.CONFIGS[NAME])


@pytest.fixture(scope="module")
def params(jparams):
    return _cross(jparams)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["layers"].items()}


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(3, 512, (b, s)).astype(
        np.int32)


def _x(seed, t):
    return np.random.default_rng(seed).standard_normal(
        (t, CFG.hidden_dim)).astype(np.float32)


def _close(want, got, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# -- configs and parameters ---------------------------------------------------


def test_configs_and_registry_match_reference():
    assert set(tm.CONFIGS) == set(jm.CONFIGS)
    for name, cfg in jm.CONFIGS.items():
        assert dataclasses.asdict(tm.CONFIGS[name]) == dataclasses.asdict(cfg)
        assert tm.num_params(tm.CONFIGS[name]) == jm.num_params(cfg)
        assert tm.active_params_per_token(tm.CONFIGS[name]) == (
            jm.active_params_per_token(cfg))
        family, tcfg = get_model(name)
        assert family == "moe" and tcfg is tm.CONFIGS[name]
        assert family_module(tcfg) is tm
    assert family_module(tl.CONFIGS["tiny-llama"]) is tl


def test_param_tree_crosses_unchanged(jparams, params):
    shapes = tm.param_shapes(CFG)
    for key, leaf in jparams["layers"].items():
        assert tuple(params["layers"][key].shape) == leaf.shape
        assert shapes["layers"][key] == leaf.shape
    assert tcommon.count_params(params) == jm.num_params(CFG)
    # A bf16 crossing rounds every floating leaf but the router.
    bf16 = _cross(jparams, torch.bfloat16)
    assert bf16["layers"]["router"].dtype == torch.float32
    assert torch.equal(bf16["layers"]["router"], params["layers"]["router"])
    assert bf16["layers"]["w_gate"].dtype == torch.bfloat16


def test_init_params_shapes_dtypes_and_seed():
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    p = tm.init_params(cfg, CPU, seed=3)
    shapes = tm.param_shapes(cfg)
    for key, shape in shapes["layers"].items():
        assert tuple(p["layers"][key].shape) == shape
        want = torch.float32 if key == "router" else torch.bfloat16
        assert p["layers"][key].dtype == want
    assert tcommon.count_params(p) == tm.num_params(cfg)
    again = tm.init_params(cfg, CPU, seed=3)
    other = tm.init_params(cfg, CPU, seed=4)
    assert torch.equal(p["layers"]["w_down"], again["layers"]["w_down"])
    assert not torch.equal(p["layers"]["w_down"], other["layers"]["w_down"])
    # Experts of one layer are distinct draws at the fan-in scale.
    bank = p["layers"]["w_gate"][0].float()
    assert not torch.equal(bank[0], bank[1])
    assert abs(bank.std().item() - 0.88 * CFG.hidden_dim ** -0.5) < 5e-3


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("factor", [1.0, 1.25, 0.5, 2.0, 8.0])
def test_capacity_equals_reference(factor):
    jcfg = dataclasses.replace(jm.CONFIGS["mixtral-8x7b"],
                               capacity_factor=factor)
    tcfg = dataclasses.replace(tm.CONFIGS["mixtral-8x7b"],
                               capacity_factor=factor)
    for t in (1, 2, 7, 8, 31, 32, 33, 100, 512, 4096, 16384):
        assert tm._capacity(tcfg, t) == jm._capacity(jcfg, t)
        assert tm._capacity(tcfg, t) % 8 == 0


@pytest.mark.parametrize("factor", [1.25, TIGHT], ids=["default", "drops"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_route_matches_reference(jparams, params, factor, masked):
    jcfg = dataclasses.replace(jm.CONFIGS[NAME], capacity_factor=factor)
    tcfg = dataclasses.replace(CFG, capacity_factor=factor)
    t = 64
    x = _x(1, t)
    valid = np.random.default_rng(2).random(t) > 0.3 if masked else None
    cap = tm._capacity(tcfg, t)
    want = jm.route(jnp.asarray(x), jparams["layers"]["router"][1], jcfg, cap,
                    None if valid is None else jnp.asarray(valid))
    got = tm.route(torch.from_numpy(x), params["layers"]["router"][1], tcfg,
                   cap, None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(want[1], got[1], ROUTE_TOL)
    _close(want[2], got[2], ROUTE_TOL)
    dispatch = got[0].numpy()
    # Each (expert, slot) holds at most one pair, each token at most k.
    assert dispatch.sum(0).max() <= 1
    assert dispatch.sum((1, 2)).max() <= CFG.experts_per_token
    kept = dispatch.sum()
    real = t if valid is None else int(valid.sum())
    if valid is not None:
        assert dispatch[~valid].sum() == 0  # padding takes no slot
    if factor == TIGHT:
        assert kept < real * CFG.experts_per_token  # pairs were dropped
    else:
        assert kept == real * CFG.experts_per_token


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router columns tie every token's probabilities: lax.top_k
    and the port both pick the lower expert ids."""
    router = np.zeros((CFG.hidden_dim, CFG.num_experts), np.float32)
    x = _x(3, 16)
    cap = tm._capacity(CFG, 16)
    want = jm.route(jnp.asarray(x), jnp.asarray(router), jm.CONFIGS[NAME],
                    cap)
    got = tm.route(torch.from_numpy(x), torch.from_numpy(router), CFG, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].sum((0, 2)).tolist() == [16, 16, 0, 0]


@pytest.mark.parametrize("factor", [1.25, TIGHT], ids=["default", "drops"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_moe_ffn_matches_reference(jparams, params, factor, masked):
    jcfg = dataclasses.replace(jm.CONFIGS[NAME], capacity_factor=factor)
    tcfg = dataclasses.replace(CFG, capacity_factor=factor)
    x = _x(4, 4 * 16).reshape(4, 16, -1)
    valid = (np.random.default_rng(5).random((4, 16)) > 0.3) if masked else None
    jout, jaux = jm.moe_ffn(jnp.asarray(x), _layer(jparams), jcfg,
                            None if valid is None else jnp.asarray(valid))
    tv = None if valid is None else torch.from_numpy(valid)
    out, aux = tm.moe_ffn(torch.from_numpy(x), _layer(params), tcfg, tv)
    ref, ref_aux = tm.moe_ffn_ref(torch.from_numpy(x), _layer(params), tcfg,
                                  tv)
    _close(jout, out)
    _close(ref, out, 1e-5)  # the index form is the one-hot form's function
    assert abs(aux.item() - float(jaux)) < 1e-5
    assert abs(ref_aux.item() - aux.item()) < 1e-6
    if valid is not None:  # padding contributes no output
        assert out[torch.from_numpy(~valid)].abs().max().item() == 0.0


# -- forward ------------------------------------------------------------------


def test_cache_free_forward_and_aux(jparams, params):
    toks = _tokens(6, 2, 48)
    jlog, _, jaux = jm.forward_with_aux(jparams, jm.CONFIGS[NAME],
                                        jnp.asarray(toks))
    tlog, cache, aux = tm.forward_with_aux(params, CFG, torch.from_numpy(toks))
    assert cache is None and tlog.dtype == torch.float32
    _close(jlog, tlog)
    np.testing.assert_array_equal(tlog.numpy().argmax(-1),
                                  np.asarray(jlog).argmax(-1))
    assert abs(aux.item() - float(jaux)) < 1e-5
    assert 0.99 <= aux.item() <= CFG.num_experts + 1e-3


def test_cached_forward_with_padding_matches_reference(jparams, params):
    """A right-padded prefill into a cache with `valid`, then decode
    steps: every step's logits equal the JAX package's."""
    toks = _tokens(7, 2, 16)
    valid = np.arange(16)[None, :] < np.array([[11], [16]])
    jcache = jl.KVCache.create(jm.CONFIGS[NAME], 2, 32)
    tcache = tl.KVCache.create(CFG, 2, 32, CPU)
    jlog, jcache = jm.forward(jparams, jm.CONFIGS[NAME], jnp.asarray(toks),
                              jcache, valid=jnp.asarray(valid))
    tlog, tcache = tm.forward(params, CFG, torch.from_numpy(toks), tcache,
                              valid=torch.from_numpy(valid))
    _close(np.asarray(jlog)[valid], tlog.numpy()[valid])
    for step in range(4):
        nxt = _tokens(20 + step, 2, 1)
        jlog, jcache = jm.forward(jparams, jm.CONFIGS[NAME], jnp.asarray(nxt),
                                  jcache)
        tlog, tcache = tm.forward(params, CFG, torch.from_numpy(nxt), tcache)
        _close(jlog, tlog)
    assert tcache.length.tolist() == [20, 20]


def test_cached_decode_matches_full_forward(params):
    """Prefill + decode through the cache equal the uncached forward on
    the same sequence at a capacity that binds nothing (with a binding
    capacity, which pairs drop depends on the step's token count)."""
    cfg = dataclasses.replace(CFG, capacity_factor=float(CFG.num_experts))
    seq = torch.from_numpy(_tokens(8, 1, 12))
    full, _ = tm.forward(params, cfg, seq)
    cache = tl.KVCache.create(cfg, 1, 32, CPU)
    _, cache = tm.forward(params, cfg, seq[:, :8], cache)
    steps = []
    for i in range(8, 12):
        logits, cache = tm.forward(params, cfg, seq[:, i: i + 1], cache)
        steps.append(logits[:, 0])
    _close(full[:, 8:12].numpy(), torch.stack(steps, 1).numpy(), 1e-4)


def test_padding_does_not_change_real_tokens(params):
    """Routing is batch-global: padding marked invalid takes no expert
    capacity, so a bucket's padding never changes the real positions
    (capacity grows with the bucket, so it binds in neither here)."""
    tcfg = CFG
    real = torch.from_numpy(_tokens(9, 2, 6))

    def run(pad_to):
        toks = torch.zeros((2, pad_to), dtype=torch.long)
        toks[:, :6] = real
        valid = (torch.arange(pad_to)[None, :] < 6).expand(2, pad_to)
        cache = tl.KVCache.create(tcfg, 2, pad_to + 8, CPU)
        logits, _ = tm.forward(params, tcfg, toks, cache, valid=valid)
        return logits[:, :6].numpy()

    np.testing.assert_allclose(run(8), run(32), atol=1e-5, rtol=1e-5)


def test_idle_rows_masked_at_decode_match_reference(jparams, params):
    """A 16-row decode step at a binding capacity: with half the rows
    masked idle the live rows' logits equal the JAX package's, and
    differ from the step that lets the idle rows route."""
    jcfg = dataclasses.replace(jm.CONFIGS[NAME], capacity_factor=TIGHT)
    tcfg = dataclasses.replace(CFG, capacity_factor=TIGHT)
    b = 16
    prompt = _tokens(10, b, 8)
    active = np.arange(b) % 2 == 0

    def step(valid):
        jcache = jl.KVCache.create(jcfg, b, 16)
        tcache = tl.KVCache.create(tcfg, b, 16, CPU)
        _, jcache = jm.forward(jparams, jcfg, jnp.asarray(prompt), jcache)
        _, tcache = tm.forward(params, tcfg, torch.from_numpy(prompt), tcache)
        nxt = _tokens(11, b, 1)
        jv = None if valid is None else jnp.asarray(valid[:, None])
        tv = None if valid is None else torch.from_numpy(valid[:, None])
        jlog, _ = jm.forward(jparams, jcfg, jnp.asarray(nxt), jcache, valid=jv)
        tlog, _ = tm.forward(params, tcfg, torch.from_numpy(nxt), tcache,
                             valid=tv)
        _close(jlog, tlog)
        return tlog.numpy()[active]

    assert np.abs(step(active) - step(None)).max() > 1e-3


# -- int8 -----------------------------------------------------------------------


def test_int8_leaves_banks_and_router_dense(params):
    targets = dict(quant.quantize_targets(tm.param_shapes(CFG)))
    assert ("layers", "router") not in targets
    for name in ("w_gate", "w_up", "w_down"):
        assert ("layers", name) not in targets
    assert {("layers", "wqkv"), ("layers", "wo"), ("lm_head",),
            ("embed",)} <= set(targets)
    copy = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in params.items()}
    eng = GenerationEngine(CFG, ServingConfig(model=NAME, quantize="int8"),
                           params=copy, device="cpu")
    layers = eng.params["layers"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert isinstance(layers[name], torch.Tensor), name
        assert torch.equal(layers[name], params["layers"][name])
    assert layers["router"].dtype == torch.float32
    assert isinstance(layers["wqkv"], quant.QuantizedTensor)
    out, _ = eng.generate([[5, 6, 7, 8]], max_new_tokens=4)
    assert len(out[0]) == 4
    synth = GenerationEngine(
        CFG, ServingConfig(model=NAME, quantize="int8",
                           synthetic_weights=True), device="cpu")
    s_layers = synth.params["layers"]
    assert s_layers["router"].dtype == torch.float32
    assert isinstance(s_layers["w_down"], torch.Tensor)
    assert tuple(s_layers["w_down"].shape) == tm.param_shapes(CFG)[
        "layers"]["w_down"]


# -- engine -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(jparams, params):
    jeng = JEngine(jm.CONFIGS[NAME],
                   JServing(model=NAME, mesh=MeshConfig(tensor=1)),
                   mesh=_mesh(), params=jparams)
    teng = GenerationEngine(CFG, ServingConfig(model=NAME), params=params,
                            device="cpu")
    return jeng, teng


def _prompts(lengths=(5, 12, 30, 9, 41, 16), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 500, n).tolist() for n in lengths]


def test_engine_generate_matches_reference(engines):
    jeng, teng = engines
    assert teng.fam is tm
    prompts = _prompts()[:3]
    want, want_reasons = jeng.generate(prompts, max_new_tokens=10)
    got, reasons = teng.generate(prompts, max_new_tokens=10)
    assert got == want and reasons == want_reasons
    assert list(teng.generate_stream(prompts[1], max_new_tokens=10)) == want[1]
    jsampled, _ = jeng.generate(prompts, max_new_tokens=10, seed=5,
                                sampling=JSampling(temperature=0.8, top_k=20))
    sampled, _ = teng.generate(prompts, max_new_tokens=10, seed=5,
                               sampling=SamplingConfig(temperature=0.8,
                                                       top_k=20))
    assert sampled == jsampled
    info = teng.model_info()
    assert info["family"] == "moe" == jeng.model_info()["family"]
    assert info["num_params_million"] == jm.num_params(CFG) // 10 ** 6


def test_engine_refusals_match_reference(params):
    with pytest.raises(ValueError, match="speculative decoding supports "
                       "dense decoder targets only"):
        GenerationEngine(CFG, ServingConfig(model=NAME,
                                            speculative_draft="tiny-llama"),
                         params=params, device="cpu")
    with pytest.raises(ValueError, match="lora serving supports dense "
                       "Llama only"):
        GenerationEngine(CFG, ServingConfig(
            model=NAME, lora=LoraConfig(adapters=["a"])), params=params,
            device="cpu")
    eng = GenerationEngine(CFG, ServingConfig(model=NAME), params=params,
                           device="cpu")
    with pytest.raises(ValueError, match="paged_kv supports dense Llama"):
        ContinuousBatcher(eng, BatchingConfig(paged_kv="on"))
    with pytest.raises(ValueError, match="paged_kv supports dense Llama"):
        Sidecar(ServingConfig(model=NAME, batching=BatchingConfig(
            paged_kv="on", paged_kv_host_bytes=1 << 20)), params=params,
            device="cpu")


def test_jump_ahead_gated_off(params, caplog):
    eng = GenerationEngine(CFG, ServingConfig(
        model=NAME, grammar=GrammarConfig(jump_max=8)), params=params,
        device="cpu")
    with caplog.at_level(logging.WARNING, logger="ggrmcp.torch.batching"):
        batcher = ContinuousBatcher(eng, BatchingConfig())
    assert batcher._jump_max == 0 and batcher._is_moe
    assert "jump_max > 0 is dense-family only" in caplog.text


# -- batcher ------------------------------------------------------------------


async def _serve(batcher, reqs):
    """Submit every request before the loop starts, so both packages see
    the same admission rounds whatever the machine's load; then drain."""
    its = [batcher.submit(p, m, s, seed=seed) for p, m, s, seed in reqs]
    batcher.start()

    async def drain(it):
        out = []
        async for ids, _ in it:
            out.extend(ids)
        return out

    try:
        return await asyncio.wait_for(
            asyncio.gather(*(drain(it) for it in its)), timeout=120)
    finally:
        await batcher.stop()


def _mix(prompts, sampled, new=(4, 9, 6, 12, 3, 8)):
    """(prompt, max_new, sampling, seed) rows: greedy and sampled rows
    alternate, max_new differs so rows leave the pool early."""
    rows = []
    for i, p in enumerate(prompts):
        hot = sampled and i % 2
        rows.append((p, new[i % len(new)], hot, 11 + i))
    return rows


def _reqs(rows, jax_side):
    cls = JSampling if jax_side else SamplingConfig
    return [(p, m, cls(temperature=0.8, top_k=20) if hot else cls(), seed)
            for p, m, hot, seed in rows]


async def _both(jeng, teng, rows, jcls=JBatcher, tcls=ContinuousBatcher, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("max_queue_delay_ms", 1000.0)
    want = await _serve(jcls(jeng, JBatching(**kw)), _reqs(rows, True))
    port = tcls(teng, BatchingConfig(**kw))
    got = await _serve(port, _reqs(rows, False))
    return want, got, port


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
async def test_batcher_routes_match_reference(engines, sampled):
    """Fused admissions (short prompts), chunked ones (30 and 41 tokens
    over a 16-token chunk, a padding row in their group) and the decode
    ticks, rows leaving early."""
    want, got, port = await _both(*engines, _mix(_prompts(), sampled))
    assert got == want and all(got)
    assert port.fused_admissions > 0 and port.chunked_admissions > 0


@pytest.fixture(scope="module")
def tight(jparams, params):
    jcfg = dataclasses.replace(jm.CONFIGS[NAME], capacity_factor=TIGHT)
    tcfg = dataclasses.replace(CFG, capacity_factor=TIGHT)
    jeng = JEngine(jcfg, JServing(model=NAME, mesh=MeshConfig(tensor=1)),
                   mesh=_mesh(), params=jparams)
    teng = GenerationEngine(tcfg, ServingConfig(model=NAME), params=params,
                            device="cpu")
    return jeng, teng


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
async def test_batcher_tight_capacity_idle_slots_match_reference(tight,
                                                                 sampled):
    """16 slots at a binding capacity: admissions and ticks drop pairs.
    The three long prompts queued first take slots 0-2 (one chunked
    group), so the short prompts' full-pool fused call has rows 0-2 not
    admitted ahead of its real rows: they must take no capacity, and as
    rows finish, neither must the idle slots of a tick (the slot order
    is the flattened (token, k) order, so an unmasked row ahead of a
    live one takes its slots)."""
    # The short prompts nearly fill their 32-token bucket, so the fused
    # call's capacity (from its padded [16, 32] shape) binds too.
    prompts = _prompts(lengths=(40, 50, 70, 32, 31, 30, 32, 29, 32, 31, 30,
                                32), seed=1)
    rows = _mix(prompts, sampled, new=(3, 14, 6, 10, 2, 12))
    want, got, _ = await _both(*tight, rows, max_batch_size=16,
                               prefill_chunk=32)
    assert got == want and all(got)


async def _waves(batcher, waves):
    """Serve each wave of requests to its end, one after the other, on
    one running batcher (every wave lands in one admission round)."""
    batcher.start()

    async def drain(it):
        out = []
        async for ids, _ in it:
            out.extend(ids)
        return out

    try:
        outs = []
        for reqs in waves:
            its = [batcher.submit(p, m, s, seed=seed)
                   for p, m, s, seed in reqs]
            outs.append(await asyncio.wait_for(
                asyncio.gather(*(drain(it) for it in its)), timeout=120))
        return outs
    finally:
        await batcher.stop()


async def test_interleave_matches_reference(tight):
    """Greedy, at a binding capacity: a 40- and a 100-token prompt arrive
    together while a short row decodes and ride the ticks in 16-token
    chunks; after the first finishes, its idle interleave row (row 0,
    ahead of the live one) must take no capacity. Tokens and counters
    are the JAX batcher's (four slots: a tick's pairs never exceed the
    capacity floor of 8, so the decode rows are batch-independent)."""
    jeng, teng = tight
    kw = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
              prefill_interleave="on", prefill_interleave_rows=2,
              pipeline_ticks="off", max_queue_delay_ms=1000.0)
    short, long_, long2 = _prompts(lengths=(6, 40, 100), seed=2)

    async def mid_decode(batcher, sampling):
        batcher.start()
        try:
            started = asyncio.Event()

            async def drain(prompt, new, seed, flag=None):
                out = []
                async for ids, _ in batcher.submit(prompt, new, sampling,
                                                   seed=seed):
                    if flag is not None:
                        flag.set()
                    out.extend(ids)
                return out

            first = asyncio.create_task(drain(short, 40, 1, started))
            await started.wait()
            longs = await asyncio.wait_for(asyncio.gather(
                drain(long_, 8, 2), drain(long2, 8, 3)), timeout=120)
            return [await first, *longs]
        finally:
            await batcher.stop()

    jb = JBatcher(jeng, JBatching(**kw))
    want = await mid_decode(jb, JSampling())
    tb = ContinuousBatcher(teng, BatchingConfig(**kw))
    got = await mid_decode(tb, SamplingConfig())
    assert got == want and all(got)
    assert tb.interleaved_admissions == 2
    assert tb.interleaved_chunks == jb.counter_stats()["interleaved_chunks"]


async def test_prefix_pool_matches_reference(engines):
    """A fused same-preamble wave learns its preamble into the prefix
    pool; a second wave's rows hit it and prefill only their suffixes,
    one [4, 1, W] group call."""
    pre = _prompts(lengths=(24,), seed=3)[0]
    waves = [[(pre + [40 + i + 10 * w, 7, 9], 6, bool(i % 2), i + 4 * w)
              for i in range(4)] for w in range(2)]
    kw = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=64,
              prefix_cache_entries=2, prefix_cache_min_seq=8,
              prefix_cache_max_seq=64, max_queue_delay_ms=1000.0)
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**kw))
    want = await _waves(jb, [_reqs(w, True) for w in waves])
    tb = ContinuousBatcher(teng, BatchingConfig(**kw))
    got = await _waves(tb, [_reqs(w, False) for w in waves])
    assert got == want and all(all(w) for w in got)
    assert tb.prefix_hits == jb.counter_stats()["prefix_cache_hits"] == 4


async def test_tiers_match_reference(engines):
    rows = _mix(_prompts(lengths=(5, 8, 12, 70, 6, 60), seed=4), True)
    want, got, tiered = await _both(
        *engines, rows, jcls=JTiered, tcls=TieredBatcher,
        kv_tiers=[[64, 3], [256, 2]])
    assert got == want and all(got)
    assert [t.fused_admissions + t.chunked_admissions
            for t in tiered.tiers] == [4, 2]


async def test_ring_matches_contiguous_windowed_generate():
    """tiny-moe-sw through the ring batcher (capacity window 16 + chunk
    8 - 1), wrapping it, against the contiguous windowed generate."""
    jcfg = jm.CONFIGS["tiny-moe-sw"]
    params = _cross(jm.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = tm.CONFIGS["tiny-moe-sw"]
    ring = GenerationEngine(cfg, ServingConfig(
        model="tiny-moe-sw", kv_ring=True,
        batching=BatchingConfig(max_batch_size=4, prefill_chunk=8)),
        params=params, device="cpu")
    assert ring.ring_capacity == cfg.sliding_window + 8 - 1
    ref = GenerationEngine(cfg, ServingConfig(model="tiny-moe-sw"),
                           params=params, device="cpu")
    prompt = [(i * 11 + 3) % 500 + 1 for i in range(30)]
    want = ref.generate([prompt], max_new_tokens=20)[0][0]
    batcher = ContinuousBatcher(ring, BatchingConfig(
        max_batch_size=4, prefill_chunk=8, max_queue_delay_ms=1000.0))
    got = await _serve(batcher, [(prompt, 20, SamplingConfig(), 0)])
    assert got == [want]
    assert batcher.chunked_admissions == 1


# -- sidecar ------------------------------------------------------------------


async def test_sidecar_and_gateway_serve_moe():
    """A tiny-moe sidecar answers Generate and GetModelInfo (family
    "moe", the parameter count) with the JAX sidecar's tokens, GetMemory
    counts the expert banks and the float32 router in its weights, and
    one MCP tools/call through the unchanged reference gateway returns
    the same tokens."""
    import aiohttp

    from ggrmcp_tpu.core import config as cfgmod
    from ggrmcp_tpu.gateway.app import Gateway

    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    jside = JSidecar(JServing(model=NAME, mesh=MeshConfig(tensor=1),
                              batching=JBatching(**small)), mesh=_mesh())
    tparams = _cross(jside.generation.params)
    tside = Sidecar(ServingConfig(model=NAME,
                                  batching=BatchingConfig(**small)),
                    params=tparams, device="cpu")
    jport, tport = await jside.start(0), await tside.start(0)
    req = serving_pb2.GenerateRequest(prompt="mixture of experts",
                                      max_new_tokens=8, return_tokens=True)
    gw = None
    try:
        tokens = []
        for port in (jport, tport):
            async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
                gen = ch.unary_unary(
                    "/ggrmcp.tpu.GenerateService/Generate",
                    request_serializer=serving_pb2.GenerateRequest
                    .SerializeToString,
                    response_deserializer=serving_pb2.GenerateResponse
                    .FromString)
                tokens.append(list((await gen(req)).token_ids))
                info = await ch.unary_unary(
                    "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                    request_serializer=serving_pb2.ModelInfoRequest
                    .SerializeToString,
                    response_deserializer=serving_pb2.ModelInfoResponse
                    .FromString)(serving_pb2.ModelInfoRequest())
                assert info.family == "moe" and info.model_id == NAME
                assert info.num_params_million == jm.num_params(CFG) // 10**6
        assert tokens[0] == tokens[1] and tokens[1]
        async with grpc.aio.insecure_channel(f"localhost:{tport}") as ch:
            memory = await ch.unary_unary(
                "/ggrmcp.tpu.DebugService/GetMemory",
                request_serializer=serving_pb2.MemoryRequest.SerializeToString,
                response_deserializer=serving_pb2.MemoryResponse.FromString,
            )(serving_pb2.MemoryRequest(reconcile=True))
        weights = {c.component: c.bytes for c in memory.components}["weights"]
        assert weights == tcommon.param_bytes(tparams)
        assert memory.total_bytes + memory.unattributed_bytes == (
            memory.live_bytes)

        cfg = cfgmod.default()
        cfg.server.host = "127.0.0.1"
        cfg.server.port = 0
        cfg.grpc.reconnect.enabled = False
        gw = Gateway(cfg, targets=[f"localhost:{tport}"])
        await gw.start()
        async with aiohttp.ClientSession(
                base_url=f"http://127.0.0.1:{gw.port}") as client:
            resp = await client.post("/", json={
                "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                "params": {
                    "name": "ggrmcp_tpu_generateservice_generate",
                    "arguments": {"prompt": "mixture of experts",
                                  "maxNewTokens": 8, "returnTokens": True},
                },
            })
            data = await resp.json()
        assert "error" not in data, data
        payload = json.loads(data["result"]["content"][0]["text"])
        assert payload["tokenIds"] == tokens[0]
    finally:
        if gw is not None:
            await gw.stop()
        await tside.stop()
        await jside.stop()


def test_sidecar_depth_cut():
    """serving.num_layers serves a registry model's first layers at full
    width (random weights); the count it reports is the cut config's."""
    side = Sidecar(ServingConfig(model=NAME, num_layers=1), device="cpu")
    cut = dataclasses.replace(CFG, num_layers=1)
    assert side.family == "moe" and side.generation.cfg == cut
    assert tcommon.count_params(side.generation.params) == tm.num_params(cut)
    with pytest.raises(ValueError, match="exceeds"):
        Sidecar(ServingConfig(model=NAME, num_layers=3), device="cpu")
    with pytest.raises(ValueError, match="num_layers"):
        ServingConfig(num_layers=-1)
