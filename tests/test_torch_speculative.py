"""Speculative decoding ops of the port (`ops/speculative.py`, the vector
draws of `ops/sampling.py`) against the JAX package's: the same
tiny-llama target and draft weights (the reference engine's draft,
crossed through `params_from_numpy`), float32, the same numpy-seeded
inputs.

- The vector threefry words equal `jax.random.bits` bit for bit; the
  uniforms too; Gumbel noise agrees to float32 rounding.
- `speculative_generate` gives the reference's tokens, rounds, drafted
  and accepted counts, greedy and sampled.
- One `spec_tick` over greedy, temperature, top-k, top-p and constrained
  rows, with and without the forced-run tables, gives the reference's
  emit, count, prev', cur', states and cache lengths, every sampled row
  draw for draw.
- Losslessness without the reference's conditional-count oracle: one
  spec_tick from a FIXED state over 2000 rows, each its own seed; the
  first emitted token's histogram against the exact filtered target
  softmax (TV distance under 0.06 at 2000 samples over 8 tokens: the
  expected TV of an exact sampler there is about 0.02), and the top-k
  support exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops import speculative as jspec
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import sampling as ts
from ggrmcp_tpu_torch.ops import speculative as tspec
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
CFG = jl.CONFIGS["tiny-llama"]
V = CFG.vocab_size


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_PAIRS: dict = {}


def engine_pair(gamma: int):
    """(JAX engine, port engine) with the same target and draft weights
    (the reference's draft from its seed + 1), cached per gamma."""
    if gamma not in _PAIRS:
        mesh = mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])
        jeng = JEngine(CFG, JServing(
            mesh=MeshConfig(tensor=1), speculative_draft="tiny-llama",
            speculative_gamma=gamma), mesh=mesh)
        teng = GenerationEngine(
            tl.CONFIGS["tiny-llama"],
            ServingConfig(speculative_draft="tiny-llama",
                          speculative_gamma=gamma),
            params=params_from_numpy(_np(jeng.params), CPU),
            draft_params=params_from_numpy(_np(jeng.draft_params), CPU),
            device="cpu",
        )
        _PAIRS[gamma] = (jeng, teng)
    return _PAIRS[gamma]


# -- vector draws -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 7, 33, 32000])
def test_random_bits_equal_jax(seed, n):
    """Word i of a vector draw is threefry at counter (0, i): exact."""
    for tag in (0, 700, 900):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
        tkey = ts.fold_in(ts.prng_key(torch.tensor(seed)), tag)
        want = np.asarray(jax.random.bits(jkey, (n,))).astype(np.int64)
        assert np.array_equal(ts.random_bits(tkey, n).numpy(), want)


@pytest.mark.parametrize("n", [4, 513, 32000])
def test_uniform_and_gumbel_match_jax(n):
    """uniform(k, (n,)) is exact; gumbel differs by float32 log rounding
    at most (a few ulp)."""
    seeds = np.array([0, 3, 99, 2**31 - 1])
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.int32))
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jkeys, 5)
    tkeys = ts.fold_in(ts.prng_key(torch.from_numpy(seeds)), 5)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jkeys))
    assert np.array_equal(ts.uniform(tkeys, n).numpy(), ju)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jkeys))
    np.testing.assert_allclose(ts.gumbel(tkeys, n).numpy(), jg, rtol=2e-6,
                               atol=2e-6)
    # The scalar draw is the vector draw's first word.
    assert np.array_equal(ts.uniform(tkeys).numpy(), ju[:, 0])


# -- speculative_generate -----------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8], [9, 9, 9], [6]]


@pytest.mark.parametrize("gamma", [1, 4])
def test_speculative_generate_greedy_matches_jax(gamma):
    jeng, teng = engine_pair(gamma)
    want = jeng.generate_speculative(PROMPTS, 24)
    got = teng.generate_speculative(PROMPTS, 24)
    assert got == want
    # Greedy speculative tokens are plain greedy generate's.
    assert got[0] == teng.generate(PROMPTS, 24)[0]
    assert got[2]["rounds"] > 0 and got[2]["drafted"] > 0


def test_speculative_generate_sampled_matches_jax():
    """Sampled rows (and a greedy row among them) draw the reference's
    threefry streams: identical tokens and counts."""
    jeng, teng = engine_pair(4)
    temps, seeds = [0.8, 0.0, 1.2, 0.5], [1, 2, 3, 4]
    want = jeng.generate_speculative(PROMPTS, 16, temperatures=temps,
                                     seeds=seeds)
    got = teng.generate_speculative(PROMPTS, 16, temperatures=temps,
                                    seeds=seeds)
    assert got == want


def test_generate_speculative_needs_draft():
    eng = GenerationEngine(tl.CONFIGS["tiny-llama"], device="cpu")
    with pytest.raises(RuntimeError, match="not configured"):
        eng.generate_speculative([[1, 2]], 4)


@pytest.mark.parametrize("draft,match", [
    ("bert-tiny", "dense decoder"), ("llama-1b", "vocab"),
])
def test_engine_rejects_bad_drafts(draft, match):
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tl.CONFIGS["tiny-llama"],
                         ServingConfig(speculative_draft=draft), device="cpu")


# -- spec_tick ----------------------------------------------------------

B, CAP, J = 8, 64, 2
ROW_KINDS = {
    # name: (temperature, top_k, top_p, grammar state)
    "greedy": (0.0, 0, 1.0, 0),
    "temperature": (0.9, 0, 1.0, 0),
    "top_k": (0.8, 5, 1.0, 0),
    "top_p": (1.1, 0, 0.8, 0),
    "constrained": (0.0, 0, 1.0, 1),
    "constrained_sampled": (0.7, 0, 1.0, 3),
    "forced": (0.0, 0, 1.0, 2),
    "mixed_greedy": (0.0, 0, 1.0, 0),
}


def _grammar_tables(rng):
    """Four states: 0 accept-all, 1 and 3 random half-vocab masks with
    random transitions, 2 forced (one allowed token, its run in the jump
    tables) into 3."""
    allow = np.ones((4, V), bool)
    trans = rng.randint(0, 4, size=(4, V)).astype(np.int32)
    trans[0] = 0
    for s in (1, 3):
        allow[s] = rng.rand(V) < 0.5
    forced = 77
    allow[2] = False
    allow[2, forced] = True
    trans[2] = 3
    j_len = np.array([0, 0, 1, 0], np.int32)
    j_tok = np.zeros((4, J), np.int32)
    j_tok[2, 0] = forced
    return allow, trans, j_len, j_tok


def _state(seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 12, size=B)
    tokens = np.zeros((B, 16), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.randint(3, V, size=n)
    cur = rng.randint(3, V, size=B).astype(np.int32)
    kinds = list(ROW_KINDS.values())
    temps = np.array([k[0] for k in kinds], np.float32)
    ks = np.array([k[1] for k in kinds], np.int32)
    ps = np.array([k[2] for k in kinds], np.float32)
    gs = np.array([k[3] for k in kinds], np.int32)
    seeds = rng.randint(0, 2**31 - 1, size=B).astype(np.uint32)
    return dict(tokens=tokens, lens=lens.astype(np.int32), cur=cur,
                temps=temps, ks=ks, ps=ps, gs=gs, seeds=seeds,
                tables=_grammar_tables(rng))


def _jax_tick(jeng, st, gamma, jump, temps):
    tc = jl.KVCache.create(CFG, B, CAP)
    dc = jl.KVCache.create(jeng.draft_cfg, B, CAP)
    toks = jnp.asarray(st["tokens"])
    _, tc = jl.forward(jeng.params, CFG, toks, tc)
    _, dc = jl.forward(jeng.draft_params, jeng.draft_cfg, toks, dc)
    lens = jnp.asarray(st["lens"])
    tc = tc._replace(length=lens)
    dc = dc._replace(length=lens - 1)
    prev = jnp.asarray(st["tokens"][np.arange(B), st["lens"] - 1])
    allow, trans, j_len, j_tok = (jnp.asarray(t) for t in st["tables"])
    out = jspec.spec_tick(
        lambda t, c: jl.forward(jeng.params, CFG, t, c),
        lambda t, c: jl.forward(jeng.draft_params, jeng.draft_cfg, t, c),
        prev, jnp.asarray(st["cur"]), tc, dc, gamma,
        jnp.asarray(st["seeds"]), jnp.int32(11), jnp.asarray(temps),
        jnp.asarray(st["ks"]), jnp.asarray(st["ps"]), jnp.asarray(st["gs"]),
        allow, trans, j_len=j_len if jump else None,
        j_tokens=j_tok if jump else None,
    )
    emit, count, tc, dc, prev2, cur2, gs2 = out
    return [np.asarray(x) for x in (emit, count, prev2, cur2, gs2,
                                     tc.length, dc.length)]


def _port_tick(teng, st, gamma, jump, temps):
    tc = tl.KVCache.create(teng.cfg, B, CAP, CPU)
    dc = tl.KVCache.create(teng.draft_cfg, B, CAP, CPU)
    toks = torch.from_numpy(st["tokens"]).long()
    tl.forward(teng.params, teng.cfg, toks, tc)
    tl.forward(teng.draft_params, teng.draft_cfg, toks, dc)
    lens = torch.from_numpy(st["lens"])
    tc.length = lens.clone()
    dc.length = lens - 1
    prev = toks[torch.arange(B), lens.long() - 1]
    allow, trans, j_len, j_tok = (torch.from_numpy(t) for t in st["tables"])
    emit, count, prev2, cur2, gs2 = tspec.spec_tick(
        lambda t, c: teng.verify_forward(teng.params, t, c),
        lambda t, c: teng.draft_forward(teng.draft_params, t, c),
        prev, torch.from_numpy(st["cur"]).long(), tc, dc, gamma,
        torch.from_numpy(st["seeds"].astype(np.int64)), 11,
        None if temps is None else torch.from_numpy(temps),
        torch.from_numpy(st["ks"]), torch.from_numpy(st["ps"]),
        torch.from_numpy(st["gs"]), allow, trans,
        j_len if jump else None, j_tok if jump else None,
    )
    return [x.numpy() for x in (emit, count, prev2, cur2, gs2, tc.length,
                                 dc.length)]


@pytest.mark.parametrize("jump", [False, True], ids=["no_jump", "jump"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_tick_matches_jax(seed, jump):
    """Every row kind in one round: the port's outputs equal the
    reference's, sampled rows draw for draw (8 rows a round, 4 of them
    sampled: 12 sampled rows over the three seeds, all expected equal
    since every random word is the reference's)."""
    gamma = 4
    jeng, teng = engine_pair(gamma)
    st = _state(seed)
    want = _jax_tick(jeng, st, gamma, jump, st["temps"])
    got = _port_tick(teng, st, gamma, jump, st["temps"])
    names = ("emit", "count", "prev", "cur", "gstate", "tlen", "dlen")
    sampled = st["temps"] > 0
    same_rows = [
        i for i in range(B)
        if all(np.array_equal(g[i], w[i]) for g, w in zip(got, want))
    ]
    assert sum(sampled[same_rows]) == int(sampled.sum()) == 4
    for name, g, w in zip(names, got, want):
        assert np.array_equal(g, w), name
    # Constrained rows stay inside their masks along the emitted path.
    allow, trans = st["tables"][:2]
    emit, count = got[0], got[1]
    for i in np.nonzero(st["gs"])[0]:
        s = st["gs"][i]
        for t in emit[i, : count[i]]:
            assert allow[s, t]
            s = trans[s, t]


def test_spec_tick_all_greedy_skips_draws():
    """temps None (no row samples) gives the tokens of temps all zero,
    without a draw."""
    gamma = 4
    _, teng = engine_pair(gamma)
    st = _state(5)
    zeros = np.zeros(B, np.float32)
    a = _port_tick(teng, st, gamma, True, zeros)
    b = _port_tick(teng, st, gamma, True, None)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# -- losslessness from a fixed state ------------------------------------

NANO = tl.LlamaConfig(
    name="nano-llama-spec", vocab_size=8, hidden_dim=32, num_layers=2,
    num_heads=2, num_kv_heads=2, head_dim=16, ffn_dim=64, max_seq_len=64,
    dtype="float32",
)
ROWS = 2000  # every row one sample: the sample size is fixed
TV_BOUND = 0.06


@pytest.fixture(scope="module")
def nano():
    return (tl.init_params(NANO, CPU, seed=3),
            tl.init_params(NANO, CPU, seed=4))


def _first_tokens(nano, temp, top_k):
    """One spec_tick from the same state on every row, seeds 0..ROWS-1;
    returns (first emitted tokens, exact filtered target p)."""
    target, draft = nano
    prompt = torch.tensor([[3, 1, 4, 1]]).expand(ROWS, 4)
    cur = torch.full((ROWS,), 5, dtype=torch.long)
    tc = tl.KVCache.create(NANO, ROWS, 16, CPU)
    dc = tl.KVCache.create(NANO, ROWS, 16, CPU)
    tl.forward(target, NANO, prompt, tc)
    tl.forward(draft, NANO, prompt, dc)
    dc.length = dc.length - 1
    temps = torch.full((ROWS,), temp)
    ks = torch.full((ROWS,), top_k, dtype=torch.long)
    ps = torch.ones(ROWS)
    allow, trans = ts.trivial_grammar_tables(NANO.vocab_size, CPU)
    emit, count, _, _, _ = tspec.spec_tick(
        lambda t, c: tl.forward(target, NANO, t, c),
        lambda t, c: tl.forward(draft, NANO, t, c),
        prompt[:, -1], cur, tc, dc, 4, torch.arange(ROWS), 1, temps, ks, ps,
        torch.zeros(ROWS, dtype=torch.long), allow, trans,
    )
    logits, _ = tl.forward(target, NANO, torch.tensor([[3, 1, 4, 1, 5]]))
    exact = ts.filtered_logprobs(
        logits[:, -1], temps[:1], ks[:1], ps[:1]).exp()[0].double().numpy()
    return emit[:, 0].numpy(), exact, count.numpy()


@pytest.mark.parametrize("top_k", [0, 3], ids=["temperature", "top_k"])
def test_first_token_distribution_is_target(nano, top_k):
    first, exact, count = _first_tokens(nano, 1.0, top_k)
    assert first.shape == (ROWS,)
    emp = np.bincount(first, minlength=NANO.vocab_size) / ROWS
    tv = 0.5 * np.abs(emp - exact).sum()
    assert tv < TV_BOUND, (tv, np.round(emp, 3), np.round(exact, 3))
    # The draft is imperfect: some rows reject, some accept.
    assert (count == 1).any() and (count > 1).any()
    if top_k:
        # Exact, not statistical: no emitted token leaves the support.
        support = set(np.nonzero(exact > 0)[0].tolist())
        assert len(support) == top_k
        assert set(first.tolist()) <= support
