"""Multi-LoRA (ops/lora.py, serving/adapter_arena.py) in the port against
the JAX package's, held to `tests/test_lora.py` and
`tests/test_lora_arena.py`: the same tiny-llama weights and factors,
float32, greedy.

- `lora_delta` and a LoRA'd forward equal the reference's within atol
  2e-4 (rtol 0), the factors carried over by models/convert.py.
- The engine: boot-time adapters (zero-init no-op, loaded factors,
  mixed rows, the stream, npz directory, typed refusals, int8 weights)
  give the JAX engine's tokens.
- The batcher: mixed adapters in one tick (1 and 4 decode steps),
  chunked, interleaved and jump-ahead admissions carry the adapter, the
  prefix pool stays base-only, paged chains are scoped to the adapter's
  key domain; tokens equal the JAX batcher's.
- The arena (registry mode): a mixed burst over more adapters than rows
  (churn evicts) equals each adapter served alone, fused-vs-serial on
  one device; preemption releases the pin and `_resume_reacquire` takes
  it back; an adapter'd export and import round trip; a tick-failure
  replay keeps its adapter; the sidecar's typed surface and lora_*
  stats.
"""

import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grpc
import grpc.aio
from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import Config as JConfig
from ggrmcp_tpu.core.config import LoraConfig as JLora
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import SchedulerConfig as JScheduler
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.grammar import compile_schema as j_compile
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops import lora as jlora
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    LoraConfig,
    SchedulerConfig,
    ServingConfig,
    serving_config_from_dict,
)
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import lora as tlora
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from ggrmcp_tpu_torch.utils import failpoints
from tests.test_torch_observability import serving_view
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
JCFG = jl.CONFIGS["tiny-llama"]
TCFG = tl.CONFIGS["tiny-llama"]
RANK = 4
ATOL = 2e-4
GREEDY = SamplingConfig(temperature=0.0)
JGREEDY = JSampling(temperature=0.0)


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    jfail.registry.disarm()
    yield
    failpoints.registry.disarm()
    jfail.registry.disarm()


def factors(seed: int, scale: float = 0.25):
    """A pre-scaled factor pair big enough to flip greedy argmax (the
    reference tests' calibration)."""
    rng = np.random.default_rng(seed)
    out = (JCFG.num_heads + 2 * JCFG.num_kv_heads) * JCFG.head_dim
    a = rng.normal(0, scale, (JCFG.num_layers, JCFG.hidden_dim, RANK))
    b = rng.normal(0, scale, (JCFG.num_layers, RANK, out))
    return a.astype(np.float32), b.astype(np.float32)


def _mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, jax.tree.map(np.asarray, jparams)


def _copy(tree):
    return {**tree, "layers": dict(tree["layers"])}


def _pair(weights, lora, **serving):
    """(JAX engine, port engine) on the same weights and LoRA config."""
    jparams, host = weights
    jeng = JEngine(JCFG, JServing(mesh=MeshConfig(tensor=1),
                                  lora=JLora(**lora), **serving),
                   mesh=_mesh(), params=_copy(jparams))
    teng = GenerationEngine(TCFG, ServingConfig(lora=LoraConfig(**lora),
                                                **serving),
                            params=params_from_numpy(_copy(host), CPU),
                            device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def static(weights):
    """Boot-time adapters acme (trained factors) and beta (no-op)."""
    jeng, teng = _pair(weights, dict(adapters=["acme", "beta"], rank=RANK))
    for eng in (jeng, teng):
        eng.set_lora_weights("acme", *factors(1))
    return jeng, teng


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lora-registry"))
    for i, name in enumerate(("a0", "a1", "a2", "a3")):
        a, b = factors(10 + i)
        np.savez(os.path.join(path, f"{name}.npz"), a=a, b=b)
    return path


@pytest.fixture(scope="module")
def arena(weights, registry):
    return _pair(weights, dict(registry=registry, rank=RANK, arena_rows=3))


async def collect(batcher, prompt, max_new, reference=False, **kw):
    out, reason = [], None
    async for ids, reason in batcher.submit(
            prompt, max_new, JGREEDY if reference else GREEDY, **kw):
        out.extend(ids)
    return out, reason


async def collect_named(batcher, prompt, max_new, name="", reference=False,
                        **kw):
    """Acquire by name through the host-op stream, then submit."""
    if not name:
        return await collect(batcher, prompt, max_new, reference, **kw)
    lease = await batcher.acquire_adapter(name)
    return await collect(batcher, prompt, max_new, reference,
                         adapter=lease.row, adapter_key=name,
                         adapter_lease=lease, **kw)


# -- the op and the forward -------------------------------------------------


def test_lora_delta_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    a = rng.standard_normal((4, 64, RANK)).astype(np.float32)
    b = rng.standard_normal((4, RANK, 96)).astype(np.float32)
    idx = np.array([2, 0, 3], np.int32)
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), jnp.asarray(idx)))
    got = tlora.lora_delta(*(torch.from_numpy(t) for t in (x, a, b, idx)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_lora_delta_base_row_is_exact_zero():
    gen = torch.Generator().manual_seed(3)
    lay = tlora.init_lora_layers(TCFG, 2, RANK, gen)
    a, b = lay["lora_qkv_a"], lay["lora_qkv_b"]
    assert a.shape == (TCFG.num_layers, 3, TCFG.hidden_dim, RANK)
    assert not a[:, 0].any() and a[:, 1:].any() and not b.any()
    again = tlora.init_lora_layers(TCFG, 2, RANK,
                                   torch.Generator().manual_seed(3))
    assert torch.equal(again["lora_qkv_a"], a)


def test_lora_forward_matches_reference(weights):
    """A mixed batch (base, two adapters with trained factors) through
    the cache-free forward and a cached prefill + decode step."""
    jparams, host = weights
    stacks = {}
    for key, shape in (("lora_qkv_a", (JCFG.hidden_dim, RANK)),
                       ("lora_qkv_b", (RANK, (JCFG.num_heads + 2
                                              * JCFG.num_kv_heads)
                                       * JCFG.head_dim))):
        rows = [np.zeros((JCFG.num_layers,) + shape, np.float32)]
        rows += [factors(s)[0 if key.endswith("a") else 1] for s in (1, 2)]
        stacks[key] = np.stack(rows, axis=1)
    jp = {**jparams, "layers": {**jparams["layers"],
                                **{k: jnp.asarray(v) for k, v in stacks.items()}}}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(1).integers(3, 500, (3, 12)).astype(np.int32)
    idx = np.array([0, 1, 2], np.int32)
    jlog, _ = jl.forward(jp, JCFG, jnp.asarray(toks),
                         lora_idx=jnp.asarray(idx))
    tlog, _ = tl.forward(tp, TCFG, torch.from_numpy(toks),
                         lora_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    base, _ = tl.forward(tp, TCFG, torch.from_numpy(toks))
    assert torch.equal(base[0], tlog[0])  # row 0 rides the base model
    assert not torch.allclose(base[1], tlog[1])
    jc = jl.KVCache.create(JCFG, 3, 32)
    tc = tl.KVCache.create(TCFG, 3, 32, CPU)
    jl_, jc = jl.forward(jp, JCFG, jnp.asarray(toks), jc,
                         lora_idx=jnp.asarray(idx))
    tl_, tc = tl.forward(tp, TCFG, torch.from_numpy(toks), tc,
                         lora_idx=torch.from_numpy(idx))
    step = toks[:, :1] + 1
    jl_, _ = jl.forward(jp, JCFG, jnp.asarray(step), jc,
                        lora_idx=jnp.asarray(idx))
    tl_, _ = tl.forward(tp, TCFG, torch.from_numpy(step), tc,
                        lora_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=ATOL,
                               rtol=0)


# -- the engine -------------------------------------------------------------


P = [5, 6, 7]


def test_engine_static_adapters_match_reference(static):
    jeng, teng = static
    for adapters in (None, ["acme"], ["beta"], ["acme", ""], [2, 1]):
        prompts = [P] * (len(adapters) if adapters else 1)
        want, _ = jeng.generate(prompts, max_new_tokens=6, adapters=adapters)
        got, _ = teng.generate(prompts, max_new_tokens=6, adapters=adapters)
        assert got == want
    base, _ = teng.generate([P], max_new_tokens=8)
    acme, _ = teng.generate([P], max_new_tokens=8, adapters=["acme"])
    beta, _ = teng.generate([P], max_new_tokens=8, adapters=["beta"])
    assert acme != base and beta == base
    streamed = list(teng.generate_stream(P, max_new_tokens=8,
                                         adapter="acme"))
    assert streamed == acme[0]


def test_engine_refusals_match_reference(static):
    jeng, teng = static
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="unknown adapter"):
            eng.generate([[5]], 4, adapters=["nope"])
        with pytest.raises(ValueError, match="out of range"):
            eng.generate([[5]], 4, adapters=[7])
        with pytest.raises(ValueError, match="adapters for"):
            eng.generate([[5]], 4, adapters=[0, 0])
        with pytest.raises(ValueError, match="base adapter"):
            eng.set_lora_weights("", *factors(0))
        a, b = factors(0)
        with pytest.raises(ValueError, match="factor shapes"):
            eng.set_lora_weights("beta", a[0], b)


def test_engine_gates_and_names(weights):
    for bad in ("../other", "a/b", ".hidden"):
        with pytest.raises(ValueError, match="plain name"):
            GenerationEngine(TCFG, ServingConfig(
                lora=LoraConfig(adapters=[bad], rank=RANK)), device="cpu")
    cfg = ServingConfig(lora=LoraConfig(adapters=["x"], rank=RANK))
    cfg.speculative_draft = "tiny-llama"
    with pytest.raises(ValueError, match="speculative"):
        GenerationEngine(TCFG, cfg, device="cpu")


def test_factors_load_from_npz_dir(weights, tmp_path):
    a, b = factors(3, scale=0.5)
    np.savez(tmp_path / "acme.npz", a=a, b=b)
    lora = dict(adapters=["acme", "beta"], rank=RANK, path=str(tmp_path))
    jeng, teng = _pair(weights, lora)
    for adapters in (None, ["acme"], ["beta"]):
        want, _ = jeng.generate([P], max_new_tokens=6, adapters=adapters)
        got, _ = teng.generate([P], max_new_tokens=6, adapters=adapters)
        assert got == want
    np.savez(tmp_path / "acme.npz", a=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="lora factors"):
        GenerationEngine(TCFG, ServingConfig(lora=LoraConfig(**lora)),
                         device="cpu")


def test_lora_on_int8_weights(weights):
    jeng, teng = _pair(weights, dict(adapters=["acme"], rank=RANK),
                       quantize="int8")
    base, _ = teng.generate([P], max_new_tokens=6)
    noop, _ = teng.generate([P], max_new_tokens=6, adapters=["acme"])
    assert noop == base
    for eng in (jeng, teng):
        eng.set_lora_weights("acme", *factors(2, scale=0.5))
    want, _ = jeng.generate([P], max_new_tokens=6, adapters=["acme"])
    got, _ = teng.generate([P], max_new_tokens=6, adapters=["acme"])
    assert got == want and got != base


def test_ledger_counts_lora_apart_from_weights(static, arena):
    for eng in (static[1], arena[1]):
        comp = eng.ledger.component_bytes()
        lora = comp[("", "lora")]
        assert lora == sum(v.nbytes for k, v in eng.params["layers"].items()
                           if k.startswith("lora_"))
        rec = eng.ledger.reconcile()
        assert rec["double_registered"] == 0


# -- the batcher ------------------------------------------------------------


async def _both(engines, cfg: dict, requests):
    """(prompt, max_new, adapter row) rows submitted together through the
    JAX batcher and the port's."""
    jeng, teng = engines
    outs = []
    for batcher, ref in ((JBatcher(jeng, JBatching(**cfg)), True),
                         (ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          False)):
        batcher.start()
        try:
            outs.append(await asyncio.gather(*(
                collect(batcher, p, n, ref, adapter=a, seed=i)
                for i, (p, n, a) in enumerate(requests))))
        finally:
            await batcher.stop()
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("steps", [1, 4])
async def test_mixed_adapters_one_tick(static, steps):
    jeng, teng = static
    acme = teng.resolve_adapter("acme")
    got = await _both(static, dict(max_batch_size=4, kv_cache_max_seq=256,
                                   decode_steps_per_tick=steps),
                      [(P, 6, acme), (P, 6, 0), (P, 6, acme), (P, 6, 2)])
    solo_acme, _ = teng.generate([P], max_new_tokens=6, adapters=["acme"])
    solo_base, _ = teng.generate([P], max_new_tokens=6)
    assert [o for o, _ in got] == [solo_acme[0], solo_base[0],
                                   solo_acme[0], solo_base[0]]


async def test_chunked_admission_carries_adapter(static):
    jeng, teng = static
    prompt = [5 + (i % 7) for i in range(48)]
    acme = teng.resolve_adapter("acme")
    got = await _both(static, dict(max_batch_size=2, kv_cache_max_seq=256,
                                   prefill_chunk=32),
                      [(prompt, 6, acme), (prompt[:40], 6, 0)])
    solo, _ = teng.generate([prompt], max_new_tokens=6, adapters=["acme"])
    assert got[0][0] == solo[0]


async def test_interleaved_admission_carries_adapter(static):
    """A long adapter'd prompt arriving mid-decode rides the interleave
    chunks under its adapter."""
    jeng, teng = static
    cfg = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=32,
               prefill_interleave="on", prefill_interleave_rows=2)
    long_p = [3 + (i % 11) for i in range(80)]
    acme = teng.resolve_adapter("acme")
    outs = []
    for batcher, ref in ((JBatcher(jeng, JBatching(**cfg)), True),
                         (ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          False)):
        batcher.start()
        try:
            started = asyncio.Event()

            async def short():
                out = []
                async for ids, _ in batcher.submit(
                        [9, 8, 7], 24, JGREEDY if ref else GREEDY):
                    started.set()
                    out.extend(ids)
                return out

            task = asyncio.create_task(short())
            await started.wait()
            adapterd = await collect(batcher, long_p, 6, ref, adapter=acme)
            outs.append(([await task], adapterd, batcher.interleaved_admissions))
        finally:
            await batcher.stop()
    assert outs[1] == outs[0] and outs[1][2] == 1
    solo, _ = teng.generate([long_p], max_new_tokens=6, adapters=["acme"])
    assert outs[1][1][0] == solo[0]


async def test_jump_ticks_carry_adapter(static):
    """Constrained rows with and without an adapter decode through jump
    ticks; tokens equal the JAX batcher's."""
    jeng, teng = static
    schema = {"type": "object", "properties": {
        "kind": {"const": "structured"},
        "label": {"type": "string", "maxLength": 12}},
        "required": ["kind", "label"]}
    vocab = TCFG.vocab_size
    acme = teng.resolve_adapter("acme")
    cfg = dict(max_batch_size=4, kv_cache_max_seq=256)
    outs = []
    for batcher, ref in ((JBatcher(jeng, JBatching(**cfg)), True),
                         (ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          False)):
        compile_fn = j_compile if ref else compile_schema
        batcher.start()
        try:
            outs.append(await asyncio.gather(*(
                collect(batcher, P, 40, ref, adapter=a, seed=i,
                        grammar=compile_fn(schema, vocab_size=vocab))
                for i, a in enumerate((acme, 0, acme)))))
            runs = batcher.grammar_jump_runs
        finally:
            await batcher.stop()
    assert outs[1] == outs[0]
    assert runs > 0


async def test_prefix_pool_stays_base_only(static):
    """An adapter'd request neither seeds nor reads the prefix pool."""
    jeng, teng = static
    cfg = dict(max_batch_size=4, kv_cache_max_seq=256,
               prefix_cache_entries=2, prefix_cache_min_seq=16,
               prefix_cache_max_seq=64)
    preamble = [7, 3, 9, 1] * 6 + [5]
    acme = teng.resolve_adapter("acme")
    outs = []
    for batcher, ref in ((JBatcher(jeng, JBatching(**cfg)), True),
                         (ContinuousBatcher(teng, BatchingConfig(**cfg)),
                          False)):
        batcher.start()
        try:
            seq = [await collect(batcher, preamble, 6, ref, adapter=a)
                   for a in (acme, 0, 0, acme)]
            outs.append((seq, batcher.prefix_hits, batcher.prefix_misses))
        finally:
            await batcher.stop()
    assert outs[1] == outs[0]
    assert outs[1][1] == 1  # only the second base request hit
    solo, _ = teng.generate([preamble], max_new_tokens=6, adapters=["acme"])
    assert outs[1][0][3][0] == solo[0]


async def test_paged_key_domains(arena):
    """Same-adapter sessions share prefix pages, a different adapter
    shares nothing; tokens equal each adapter served alone."""
    jeng, teng = arena
    cfg = BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                         paged_kv="on", paged_kv_page_size=16)
    batcher = ContinuousBatcher(teng, cfg)
    preamble = [7, 3, 9, 1] * 10 + [5]
    batcher.start()
    try:
        first, _ = await collect_named(batcher, preamble, 6, "a0")
        reused = batcher.pages.pages_reused
        second, _ = await collect_named(batcher, preamble, 6, "a0")
        assert second == first and batcher.pages.pages_reused > reused
        reused = batcher.pages.pages_reused
        other, _ = await collect_named(batcher, preamble, 6, "a1")
        assert batcher.pages.pages_reused == reused
    finally:
        await batcher.stop()
    for name, got in (("a0", first), ("a1", other)):
        want, _ = jeng.generate([preamble], max_new_tokens=6,
                                adapters=[name])
        assert got == want[0]


# -- the arena --------------------------------------------------------------


@pytest.mark.parametrize("paged", ["off", "on"])
async def test_mixed_burst_over_churning_arena(arena, paged):
    """A burst mixing base and four adapters over a 3-row arena (loads,
    hits and evictions), fused and paged: each stream equals the same
    adapter served alone by the JAX engine; the counters move."""
    jeng, teng = arena
    cfg = BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                         paged_kv=paged, paged_kv_page_size=16)
    names = ["a0", "", "a1", "a2", "a0", "a3", "", "a1"]
    batcher = ContinuousBatcher(teng, cfg)
    before = teng.lora_stats()
    batcher.start()
    try:
        got = []
        for wave in (names[:4], names[4:]):
            got += await asyncio.gather(*(
                collect_named(batcher, P + [i], 5, n, seed=i)
                for i, n in enumerate(wave)))
    finally:
        await batcher.stop()
    teng.adapter_arena.check_invariants()
    after = teng.lora_stats()
    assert after["lora_loads"] > before["lora_loads"]
    assert after["lora_evictions"] > before["lora_evictions"]
    for i, (name, (out, _)) in enumerate(zip(names, got)):
        want, _ = jeng.generate([P + [i % 4]], max_new_tokens=5,
                                adapters=[name])
        assert out == want[0], name


async def test_fused_mixed_equals_serial(arena):
    """The 2-device reference case held on one device: a mixed burst and
    the same requests served one by one through the same batcher."""
    _, teng = arena
    batcher = ContinuousBatcher(teng, BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256, decode_steps_per_tick=2))
    batcher.start()
    try:
        mixed = await asyncio.gather(
            collect_named(batcher, P, 6, "a0"), collect_named(batcher, P, 6),
            collect_named(batcher, P, 6, "a1"))
        serial = [await collect_named(batcher, P, 6, n)
                  for n in ("a0", "", "a1")]
    finally:
        await batcher.stop()
    assert mixed == serial
    assert len({tuple(o) for o, _ in serial}) == 3


async def test_adapterd_kv_export_import_round_trip(arena):
    jeng, teng = arena
    cfg = BatchingConfig(max_batch_size=2, kv_cache_max_seq=256,
                         paged_kv="on", paged_kv_page_size=16)
    prompt = [7, 3, 9, 1] * 10 + [5]
    src = ContinuousBatcher(teng, cfg)
    src.start()
    try:
        expect, _ = await collect_named(src, prompt, 6, "a0")
        export = await src.run_host_op(
            lambda: src.export_prompt_kv(prompt, adapter="a0"))
        assert export["pages"] == 2
    finally:
        await src.stop()
    dst = ContinuousBatcher(teng, cfg)
    dst.start()
    try:
        imported, present = await dst.run_host_op(
            lambda: dst.import_prompt_kv(prompt, 0, export["k"], export["v"],
                                         adapter="a0"))
        assert (imported, present) == (2, 0)
        assert dst.pages.chain_pages(prompt) == []  # base domain sees none
        got, _ = await collect_named(dst, prompt, 6, "a0")
        assert got == expect and dst.pages.pages_reused >= 2
    finally:
        await dst.stop()
    want, _ = jeng.generate([prompt], max_new_tokens=6, adapters=["a0"])
    assert got == want[0]


async def test_tick_failure_replay_keeps_adapter(arena):
    jeng, teng = arena
    solo, _ = jeng.generate([P], max_new_tokens=8, adapters=["a0"])
    batcher = ContinuousBatcher(teng, BatchingConfig(
        max_batch_size=2, kv_cache_max_seq=256, tick_retry_limit=2))
    batcher.start()
    failpoints.registry.arm("tick_fail", every=3, times=1)
    try:
        tokens, reason = await collect_named(batcher, P, 8, "a0")
    finally:
        failpoints.registry.disarm()
        await batcher.stop()
    assert tokens == solo[0] and batcher.replayed >= 1
    teng.adapter_arena.check_invariants()


def _sched(engine, reference: bool):
    cfg = (JScheduler if reference else SchedulerConfig)(
        enabled=True, preempt_wait_fraction=1e-6)
    return serving_view(engine, scheduler=cfg)


async def _preempt(batcher, reference, victim_name, vp, ip):
    """An adapter'd background victim decodes alone; an interactive
    request then preempts it. Returns (victim, interactive) outputs."""
    loop = asyncio.get_running_loop()
    first = loop.create_future()

    async def victim():
        lease = await batcher.acquire_adapter(victim_name)
        out, reason = [], None
        async for ids, reason in batcher.submit(
                vp, 10, JGREEDY if reference else GREEDY,
                adapter=lease.row, adapter_key=victim_name,
                adapter_lease=lease, qos_class="background"):
            out.extend(ids)
            if out and not first.done():
                first.set_result(None)
        return out, reason

    task = asyncio.ensure_future(victim())
    await asyncio.wait_for(first, timeout=120)
    got_i = await collect(batcher, ip, 4, reference, qos_class="interactive")
    return await task, got_i


@pytest.mark.parametrize("paged", ["off", "on"])
async def test_preemption_releases_and_reacquires_the_adapter(arena, paged):
    """The victim's pin is released at preemption and reacquired at the
    resume (_resume_reacquire); tokens equal the JAX batcher's and the
    uninterrupted run's, the sched_* counters agree."""
    jeng, teng = arena
    cfg = dict(max_batch_size=1, kv_cache_max_seq=128, paged_kv=paged,
               paged_kv_page_size=8)
    vp, ip = [5 + (i % 9) for i in range(14)], [4, 8, 15, 16, 23, 42, 7]
    base_v = jeng.generate([vp], max_new_tokens=10, adapters=["a0"])[0][0]
    base_i = jeng.generate([ip], max_new_tokens=4)[0][0]
    outs = []
    for ref in (True, False):
        batcher = (JBatcher(_sched(jeng, True), JBatching(**cfg)) if ref
                   else ContinuousBatcher(_sched(teng, False),
                                          BatchingConfig(**cfg)))
        batcher.start()
        try:
            got = await _preempt(batcher, ref, "a0", vp, ip)
            stats = batcher.counter_stats()
        finally:
            await batcher.stop()
        outs.append((got, {k: stats[k] for k in (
            "sched_preemptions", "sched_resumes", "sched_parked")}))
    assert outs[1] == outs[0]
    (got_v, got_i), stats = outs[1]
    assert got_v[0] == base_v and got_i[0] == base_i
    assert stats["sched_preemptions"] >= 1 and stats["sched_resumes"] >= 1
    teng.adapter_arena.check_invariants()


async def test_resume_reacquire_exhaustion_sheds_typed(arena):
    """While parked, every arena row is pinned elsewhere: the resume
    re-parks up to resume_retry_limit times, then sheds "overloaded"."""
    _, teng = arena
    view = serving_view(teng, scheduler=SchedulerConfig(
        enabled=True, preempt_wait_fraction=1e-6, resume_retry_limit=2))
    batcher = ContinuousBatcher(view, BatchingConfig(
        max_batch_size=1, kv_cache_max_seq=128))
    arena_ = teng.adapter_arena
    pins = []
    batcher.start()
    try:
        loop = asyncio.get_running_loop()
        first = loop.create_future()

        async def victim():
            lease = await batcher.acquire_adapter("a0")
            out, reason = [], None
            async for ids, reason in batcher.submit(
                    P, 40, GREEDY, adapter=lease.row, adapter_key="a0",
                    adapter_lease=lease, qos_class="background"):
                out.extend(ids)
                if out and not first.done():
                    first.set_result(None)
                    # Pin every other row while the victim decodes: its
                    # own row frees at preemption and is then taken.
                    for name in ("a1", "a2"):
                        pins.append(arena_.acquire(name))
            return out, reason

        task = asyncio.ensure_future(victim())
        await asyncio.wait_for(first, timeout=120)

        async def interactive():
            got = await collect(batcher, [4, 8, 15], 2,
                                qos_class="interactive")
            pins.append(arena_.acquire("a3"))  # the freed row
            return got

        await interactive()
        out, reason = await asyncio.wait_for(task, timeout=120)
    finally:
        for lease in pins:
            arena_.release(lease)
        await batcher.stop()
    assert reason == "overloaded"
    assert batcher.shed >= 1
    arena_.check_invariants()


async def test_sidecar_arena_surface_and_stats(weights, registry):
    """Typed resolution over gRPC: a loaded adapter changes the text, an
    unknown one is INVALID_ARGUMENT, an injected load failure ABORTED
    (and the next call loads), an all-pinned arena RESOURCE_EXHAUSTED;
    the lora_* stats count it."""
    side = Sidecar(serving_config_from_dict({"serving": {
        "model": "tiny-llama",
        "batching": {"max_batch_size": 4, "kv_cache_max_seq": 256},
        "lora": {"registry": registry, "rank": RANK, "arena_rows": 2}}}),
        device="cpu")
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    gen = channel.unary_unary(
        "/ggrmcp.tpu.GenerateService/Generate",
        request_serializer=serving_pb2.GenerateRequest.SerializeToString,
        response_deserializer=serving_pb2.GenerateResponse.FromString)
    stats_call = channel.unary_unary(
        "/ggrmcp.tpu.ModelInfoService/GetServingStats",
        request_serializer=serving_pb2.ServingStatsRequest.SerializeToString,
        response_deserializer=serving_pb2.ServingStatsResponse.FromString)

    def req(adapter=""):
        return serving_pb2.GenerateRequest(
            prompt="hello", max_new_tokens=4, adapter=adapter,
            return_tokens=True)

    try:
        base = await gen(req())
        via = await gen(req("a0"))
        assert via.token_ids != base.token_ids
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await gen(req("nope"))
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        failpoints.registry.arm("adapter_load_fail", every=1, times=1)
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await gen(req("a1"))
        assert exc.value.code() == grpc.StatusCode.ABORTED
        assert "load failed" in exc.value.details()
        failpoints.registry.disarm()
        assert (await gen(req("a1"))).finish_reason in ("length", "stop")
        arena_ = side.generation.adapter_arena
        pins = [arena_.acquire("a0"), arena_.acquire("a1")]
        try:
            with pytest.raises(grpc.aio.AioRpcError) as exc:
                await gen(req("a2"))
            assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        finally:
            for lease in pins:
                arena_.release(lease)
        stats = await stats_call(serving_pb2.ServingStatsRequest())
        assert stats.lora_adapters_registered == 4
        assert stats.lora_rows_total == 2
        assert stats.lora_loads >= 2 and stats.lora_shed >= 1
        assert stats.memory_lora_bytes > 0
        arena_.check_invariants()
    finally:
        await channel.close()
        await side.stop()


async def test_sidecar_static_adapter_field(weights):
    side = Sidecar(ServingConfig(
        batching=BatchingConfig(max_batch_size=4, kv_cache_max_seq=256),
        lora=LoraConfig(adapters=["acme", "beta"], rank=RANK)), device="cpu")
    port = await side.start(0)
    channel = grpc.aio.insecure_channel(f"localhost:{port}")
    gen = channel.unary_unary(
        "/ggrmcp.tpu.GenerateService/Generate",
        request_serializer=serving_pb2.GenerateRequest.SerializeToString,
        response_deserializer=serving_pb2.GenerateResponse.FromString)
    try:
        base = await gen(serving_pb2.GenerateRequest(
            prompt="hello", max_new_tokens=4, return_tokens=True))
        via = await gen(serving_pb2.GenerateRequest(
            prompt="hello", max_new_tokens=4, adapter="beta",
            return_tokens=True))
        assert via.token_ids == base.token_ids  # zero-init: no-op
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await gen(serving_pb2.GenerateRequest(
                prompt="hello", max_new_tokens=4, adapter="nope"))
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        await channel.close()
        await side.stop()


@pytest.mark.parametrize("lora,match", [
    (dict(registry="r", adapters=["x"]), "mutually exclusive"),
    (dict(adapters=["x"], rank=0), "rank"),
    (dict(arena_rows=0), "arena_rows"),
])
def test_lora_config_checks_match_reference(lora, match):
    cfg = JConfig()
    cfg.serving.lora = JLora(**lora)
    with pytest.raises(ValueError, match=match):
        cfg.validate()
    with pytest.raises(ValueError, match=match):
        LoraConfig(**lora)


def test_config_file_nests_lora(tmp_path):
    cfg = serving_config_from_dict({"serving": {"lora": {
        "registry": str(tmp_path), "rank": 8, "arena_rows": 2}}})
    assert cfg.lora == LoraConfig(registry=str(tmp_path), arena_rows=2)
    with pytest.raises(ValueError, match="ranks"):
        serving_config_from_dict({"serving": {"lora": {"ranks": 2}}})


async def test_gateway_binding_and_override_match_reference(registry):
    """The unchanged gateway in front of a port arena sidecar and of a
    JAX one on the same weights and registry: a tool bound to an adapter,
    an explicit `adapter` argument, the `x-adapter-id` override and the
    streaming tool's binding give the JAX sidecar's tokens; the lora
    gauges reach /metrics."""
    import json

    import aiohttp

    from ggrmcp_tpu.core.config import default as default_config
    from ggrmcp_tpu.gateway.app import Gateway
    from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar

    gen = "ggrmcp_tpu_generateservice_generate"
    stream = "ggrmcp_tpu_generateservice_generatestream"
    lora = dict(registry=registry, rank=RANK, arena_rows=3)
    batching = dict(max_batch_size=4, kv_cache_max_seq=256)
    jside = JSidecar(JServing(mesh=MeshConfig(tensor=1), lora=JLora(**lora),
                              batching=JBatching(**batching)), mesh=_mesh())
    host = jax.tree.map(np.asarray, jside.generation.params)
    tside = Sidecar(ServingConfig(lora=LoraConfig(**lora),
                                  batching=BatchingConfig(**batching)),
                    params=params_from_numpy(host, CPU), device="cpu")

    async def calls(side):
        cfg = default_config()
        cfg.server.host = "127.0.0.1"
        cfg.gateway.tools = {gen: {"adapter": "a0"}, stream: {"adapter": "a1"}}
        cfg.server.port = 0
        cfg.grpc.reconnect.enabled = False
        port = await side.start(0)
        gw = Gateway(cfg, targets=[f"localhost:{port}"])
        await gw.start()
        out = []
        try:
            async with aiohttp.ClientSession(
                    base_url=f"http://127.0.0.1:{gw.port}") as client:
                args = {"prompt": "hi", "maxNewTokens": 4,
                        "returnTokens": True}
                for tool, extra, headers in (
                    (gen, {}, {}), (gen, {"adapter": "a2"}, {}),
                    (gen, {}, {"x-adapter-id": "a2"}), (stream, {}, {}),
                ):
                    resp = await client.post("/", json={
                        "jsonrpc": "2.0", "method": "tools/call", "id": 1,
                        "params": {"name": tool,
                                   "arguments": {**args, **extra}},
                    }, headers=headers)
                    data = await resp.json()
                    assert "error" not in data, data
                    chunks = [json.loads(c["text"])
                              for c in data["result"]["content"]]
                    out.append([t for c in chunks
                                for t in c.get("tokenIds", [])])
                metrics = await (await client.get("/metrics")).text()
        finally:
            await gw.stop()
            await side.stop()
        return out, metrics

    want, _ = await calls(jside)
    got, metrics = await calls(tside)
    assert got == want
    assert got[1] == got[2] != got[0]  # the header overrides the binding
    assert "gateway_backend_lora_loads" in metrics


async def test_request_dropped_from_the_queue_returns_its_pin(arena):
    """A queued adapter'd request whose consumer leaves before admission
    is dropped from the queue with its arena pin returned (the row stays
    evictable), as a terminal request's is."""
    _, teng = arena
    batcher = ContinuousBatcher(teng, BatchingConfig(
        max_batch_size=2, kv_cache_max_seq=256))
    lease = teng.adapter_arena.acquire("a3")
    it = batcher.submit(P, 4, GREEDY, adapter=lease.row, adapter_key="a3",
                        adapter_lease=lease)
    consumer = asyncio.ensure_future(it.__anext__())
    await asyncio.sleep(0)  # the consumer is waiting for its first chunk
    consumer.cancel()
    with pytest.raises(asyncio.CancelledError):
        await consumer
    await it.aclose()
    assert teng.adapter_arena._ref[lease.row] == 1  # still queued
    batcher.start()
    try:
        await asyncio.sleep(0.2)  # one admission round drops it
        assert batcher.pending.qsize() == 0
    finally:
        await batcher.stop()
    assert lease.released and teng.adapter_arena._ref[lease.row] == 0
    teng.adapter_arena.check_invariants()
