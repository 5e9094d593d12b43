"""Meshes whose axes do not divide a weight dim or the query heads, in
the port (float32 tiny models on the CPU) against the JAX package on the
same mesh over `jax.devices()[:n]`, both from one host weight tree
crossed through numpy.

The reference places such a leaf replicated and counts it once per
(leaf, dim) in `mesh_spec_downgrades`; GSPMD serves the rest. The port
holds the leaf's block (attention with its KV heads, the FFN, the
vocabulary; `llama.whole_blocks`) whole on every tensor shard and
computes it once per device, and counts the reference's sites.

What is held: prefill and decode logits within 1e-4 (2e-4 for the MoE,
as tests/test_torch_ep.py; float32 sums in another order), greedy tokens
equal, `spec_downgrades` equal to the reference engine's after a cache
was built; embeddings within 1e-5, their count equal to the reference's
`compatible_spec` over the same tree.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import LoraConfig as JLora
from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import bert as jb
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.serving import engine as jengine
from ggrmcp_tpu_torch.core.config import (
    LoraConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine, GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")

# (model, mesh axes, the blocks held whole, vocab override). tiny-llama
# and tiny-mistral at tensor=3: no split dim divides by 3, so every
# block is whole; tiny-moe at expert=8: its 4 experts' banks are whole
# over expert; the mixed case splits its layers at tensor=4 and holds a
# 510-row vocabulary whole (510 = 2 mod 4; no catalog llama mixes them).
CASES = {
    "tiny-llama-tensor3": ("tiny-llama", {"tensor": 3},
                           {"attn", "ffn", "vocab"}, None),
    "tiny-mistral-tensor3": ("tiny-mistral", {"tensor": 3},
                             {"attn", "ffn", "vocab"}, None),
    "tiny-moe-expert8": ("tiny-moe", {"expert": 8}, set(), None),
    "mixed-tensor4": ("tiny-llama", {"tensor": 4}, {"vocab"}, 510),
}


def _full(axes):
    return {"data": 1, "tensor": 1, **axes}


def _n(axes):
    return int(np.prod(list(axes.values())))


def _configs(name, vocab):
    jfam, tfam = (jm, tm) if name == "tiny-moe" else (jl, tl)
    jcfg, tcfg = jfam.CONFIGS[name], tfam.CONFIGS[name]
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        tcfg = dataclasses.replace(tcfg, vocab_size=vocab)
    return jfam, jcfg, tcfg


@pytest.mark.parametrize("case", list(CASES))
def test_serves_like_reference(case):
    name, axes, whole, vocab = CASES[case]
    jfam, jcfg, tcfg = _configs(name, vocab)
    jparams = jfam.init_params(jax.random.PRNGKey(3), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    n = _n(axes)
    jeng = jengine.GenerationEngine(
        jcfg, JServing(model=name, mesh=JMesh(**_full(axes))),
        mesh=jmesh.build_mesh(JMesh(**_full(axes)), jax.devices()[:n]),
        params=jparams)
    teng = GenerationEngine(
        tcfg, ServingConfig(model=name, mesh=MeshConfig(**_full(axes))),
        params=params_from_numpy(host, CPU),
        mesh=tmesh.build_mesh(MeshConfig(**_full(axes)), [CPU] * n))
    assert tl.whole_blocks(tcfg, axes.get("tensor", 1)) == whole
    layers = teng.params["layers"]
    for block, leaves in tl.BLOCKS.items():
        for leaf in leaves:
            tree = layers if leaf in layers else teng.params
            if leaf in tree and axes.get("tensor", 1) > 1:
                assert isinstance(tree[leaf], Sharded)
                split = tree[leaf].factors[-1 if leaf in (
                    "wqkv", "w_gate", "w_up", "lm_head") else -2] > 1
                assert split == (block not in whole), leaf

    tokens = np.random.default_rng(0).integers(3, 500, (2, 24)).astype(
        np.int32)
    step = np.array([[17], [29]], np.int32)
    with jeng.mesh:
        want, jcache = jax.jit(jeng.prefill_forward)(
            jeng.params, tokens, jeng.make_cache(2, 64))
        want_step, _ = jax.jit(jeng.decode_forward)(jeng.params, step,
                                                    jcache)
    cache = teng.make_cache(2, 64)
    got, cache = teng.prefill_forward(teng.params, torch.from_numpy(tokens),
                                      cache)
    got_step, _ = teng.decode_forward(teng.params, torch.from_numpy(step),
                                      cache)
    atol = 2e-4 if name == "tiny-moe" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step),
                               atol=atol, rtol=0)
    assert teng.spec_downgrades == jeng.spec_downgrades > 0
    assert teng.mesh_stats() == jeng.mesh_stats()

    prompts = [[5, 6, 7, 9], [13, 3, 44, 210, 87, 6]]
    assert teng.generate(prompts, 6)[0] == jeng.generate(prompts, 6)[0]


def test_lora_and_draft_at_tensor3():
    """tiny-llama at tensor=3 holds attention whole, and with it LoRA's
    `b` factor (wqkv's block) and the tiny-llama draft's blocks: a static
    adapter's greedy tokens equal the JAX engine's on one device, and
    speculative greedy generation (lossless) the reference's plain
    greedy tokens."""
    jcfg, cfg = jl.CONFIGS["tiny-llama"], tl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(5), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(10)
    out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    a = rng.normal(0, 0.25, (cfg.num_layers, cfg.hidden_dim, 4))
    b = rng.normal(0, 0.25, (cfg.num_layers, 4, out))
    a, b = a.astype(np.float32), b.astype(np.float32)
    jmesh1 = jmesh.build_mesh(JMesh(data=1, tensor=1), jax.devices()[:1])
    jeng = jengine.GenerationEngine(
        jcfg, JServing(lora=JLora(adapters=["a0"], rank=4)), mesh=jmesh1,
        params={**jparams, "layers": dict(jparams["layers"])})
    mesh3 = tmesh.build_mesh(MeshConfig(tensor=3), [CPU] * 3)
    teng = GenerationEngine(
        cfg, ServingConfig(mesh=MeshConfig(tensor=3),
                           lora=LoraConfig(adapters=["a0"], rank=4)),
        params=params_from_numpy(host, CPU), mesh=mesh3)
    assert teng.params["layers"]["lora_qkv_b"].factors[-1] == 1
    for eng in (jeng, teng):
        eng.set_lora_weights("a0", a, b)
    prompts = [[5, 6, 7, 9, 11], [13, 3, 44, 210, 87, 6]]
    want, _ = jeng.generate(prompts, max_new_tokens=6,
                            adapters=["a0", "a0"])
    got, _ = teng.generate(prompts, 6, adapters=["a0", "a0"])
    assert got == want
    spec = GenerationEngine(
        cfg, ServingConfig(mesh=MeshConfig(tensor=3),
                           speculative_draft="tiny-llama"),
        params=params_from_numpy(host, CPU), mesh=mesh3)
    assert spec.draft_params["layers"]["wqkv"].factors[-1] == 1
    plain, _ = jeng.generate(prompts, max_new_tokens=6)
    assert spec.generate_speculative(prompts, 6)[0] == plain


def test_embeddings_like_reference():
    """bert-tiny at tensor=4: the 30522-row embedding is replicated and
    counted (the reference's one site); 2 heads do not split 4 ways, so
    attention is whole on every shard (the reference splits wqkv's 384
    columns: not a site); the FFN's 512 columns split."""
    axes = {"tensor": 4}
    cfg = jb.CONFIGS["bert-tiny"]
    jparams = jb.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.asarray, jparams)
    mesh = jmesh.build_mesh(JMesh(**_full(axes)), jax.devices()[:4])
    jeng = jengine.EmbeddingEngine(cfg, JServing(mesh=JMesh(**_full(axes))),
                                   mesh=mesh, params=jparams)
    sites = set()
    jengine._adapt_specs(jb.param_specs(cfg), jparams, mesh,
                         observer=lambda where, dim, *a: sites.add(
                             (where, dim)))
    teng = EmbeddingEngine(
        tb.CONFIGS["bert-tiny"], params=params_from_numpy(host, CPU),
        mesh=tmesh.build_mesh(MeshConfig(**_full(axes)), [CPU] * 4))
    assert sites == {("['embed']", 0)}
    assert teng.spec_downgrades == len(sites) == 1
    layers = teng.params["layers"]
    assert layers["wqkv"].factors[-1] == layers["wo"].factors[-2] == 1
    assert layers["w_in"].factors[-1] == 4
    rng = np.random.default_rng(0)
    lists = [rng.integers(1, 30522, n).tolist() for n in (5, 40, 17, 100)]
    for pooling in ("mean", "cls"):
        np.testing.assert_allclose(teng.embed(lists, pooling),
                                   jeng.embed(lists, pooling), atol=1e-5,
                                   rtol=0)
