"""Training in the port (models/training.py, the counterpart of
`ggrmcp_tpu/models/training.py`) against the JAX package on the CPU, on
weights crossed through numpy (models/convert.py):

- `lm_loss` and every gradient leaf against `jax.value_and_grad` of the
  JAX `lm_loss`: tiny-llama and tiny-mistral (a window shorter than the
  sequence) in float32, the loss at rtol 1e-5 and each gradient leaf at
  rtol 1e-4; tiny-moe with its router aux loss at rtol 1e-3. A gradient
  leaf is compared elementwise with atol = rtol x the leaf's largest
  magnitude (entries near zero carry only summation-order noise);
- three `train_step`s against the JAX `train_step` (optax `adamw`): the
  losses at rtol 1e-4, and each final param leaf elementwise within
  1e-4 of its largest magnitude, save at most one entry in 10^4, each of
  those within one learning rate a step: AdamW moves an entry by about
  lr x m / (sqrt(v) + eps), so an entry whose gradient sits at float32
  summation noise (|g| near eps) can step another way in each package.
  From fresh states and from a JAX state carried mid-run
  (`convert.train_state_from_numpy`);
- tensor=2 (and tensor=8, where every shard holds all the KV heads)
  training on the CPU mesh against the JAX package's sharded step on
  `jax.devices()[:n]`, with the replicated KV columns identical in every
  shard after the steps; `collectives.sum_tied_grads` on replicas that
  are distinct tensors;
- `FlashAttentionFn` on the CPU (its forward the plain version) giving
  autograd's gradients of `flash_attention_ref`, windowed and ragged
  too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.models import training as jtrain
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models import training as ttrain
from ggrmcp_tpu_torch.models.convert import (
    params_from_numpy,
    train_state_from_numpy,
)
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel.collectives import Sharded, sum_tied_grads
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")


def _tokens(batch, seq, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq), dtype=np.int32)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict (JAX or torch leaves)."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(
                value.detach() if isinstance(value, torch.Tensor) else value)
    return out


def _close(got, want, rtol, what):
    for name in want:
        w = np.asarray(want[name], np.float64)
        g = np.asarray(got[name], np.float64)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {name}")


LR = 3e-4  # make_optimizer's default in both packages


def _close_params(got, want, what, steps=3):
    """Each leaf within 1e-4 of its largest entry, save at most one entry
    in 10^4, each of those within LR a step."""
    for name in want:
        w = np.asarray(want[name], np.float64)
        g = np.asarray(got[name], np.float64)
        diff = np.abs(g - w)
        off = int((diff > 1e-4 * np.abs(w).max()).sum())
        assert off <= diff.size * 1e-4, f"{what} {name}: {off} entries off"
        assert diff.max() <= steps * LR, f"{what} {name}: {diff.max()}"


def _port_grads(params):
    return {name: leaf.grad for name, leaf in ttrain.named_leaves(params)}


@pytest.mark.parametrize("name,family,rtol_loss,rtol_grad", [
    ("tiny-llama", "llama", 1e-5, 1e-4),
    ("tiny-mistral", "llama", 1e-5, 1e-4),
    ("tiny-moe", "moe", 1e-3, 1e-3),
])
def test_lm_loss_and_grads_match_jax(name, family, rtol_loss, rtol_grad):
    jmod, tmod = (jl, tl) if family == "llama" else (jm, tm)
    jcfg, cfg = jmod.CONFIGS[name], tmod.CONFIGS[name]
    jparams = jmod.init_params(jax.random.PRNGKey(1), jcfg)
    toks = _tokens(2, 41, cfg.vocab_size)  # 40 inputs: past mistral's 16
    jloss, jgrads = jax.value_and_grad(jtrain.lm_loss)(
        jparams, jcfg, jnp.asarray(toks))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    for t in ttrain.stored_tensors(params):
        t.requires_grad_(True)
    loss = ttrain.lm_loss(params, cfg, torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol_loss)
    grads = _flat(_port_grads(params))
    want = _flat(jgrads)
    assert set(grads) == set(want)
    assert all(np.abs(g).max() > 0 for g in grads.values())
    _close(grads, want, rtol_grad, f"{name} grad")


def _jax_steps(state, batches, jcfg, step_fn=None):
    step_fn = step_fn or jax.jit(functools.partial(
        jtrain.train_step, cfg=jcfg, optimizer=jtrain.make_optimizer()))
    losses = []
    for b in batches:
        state, loss = step_fn(state, jnp.asarray(b))
        losses.append(float(loss))
    return state, losses


def _port_steps(state, batches, cfg, step_fn=None):
    losses = []
    for b in batches:
        if step_fn is None:
            state, loss = ttrain.train_step(state, torch.from_numpy(b), cfg)
        else:
            state, loss = step_fn(state, torch.from_numpy(b))
        losses.append(loss.item())
    return state, losses


def _whole_params(state, cfg):
    from ggrmcp_tpu_torch.models import trainer

    return trainer.state_tensors(state, cfg)[0]


@pytest.mark.parametrize("carried", [False, True],
                         ids=["fresh", "carried"])
def test_three_adamw_steps_match_optax(carried):
    name = "tiny-llama"
    jcfg, cfg = jl.CONFIGS[name], tl.CONFIGS[name]
    batches = [_tokens(2, 33, cfg.vocab_size, seed=s) for s in range(5)]
    jstate = jtrain.init_train_state(jax.random.PRNGKey(2), jcfg)
    head = batches[:2] if carried else []
    jstate, _ = _jax_steps(jstate, head, jcfg)
    host = jax.tree.map(np.asarray, jstate)
    state = train_state_from_numpy(host.params, host.opt_state,
                                   int(host.step), cfg, CPU)
    assert state.step == len(head)
    jstate, jlosses = _jax_steps(jstate, batches[len(head):][:3], jcfg)
    state, losses = _port_steps(state, batches[len(head):][:3], cfg)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == int(jstate.step)
    _close_params(_whole_params(state, cfg), _flat(jstate.params), "param")


def _jax_sharded_state(jcfg, n):
    mesh = jmesh.build_mesh(JMesh(tensor=n, data=1), jax.devices()[:n])
    state = jtrain.init_train_state(jax.random.PRNGKey(4), jcfg)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(
            mesh, jmesh.compatible_spec(s, np.shape(x), mesh))),
        state.params, jl.param_specs(jcfg))
    state = jtrain.TrainState(params, jax.device_put(state.opt_state),
                              state.step)
    step_fn, _ = jtrain.make_sharded_train_step(jcfg, mesh)
    return state, step_fn, mesh


@pytest.mark.parametrize("tensor", [2, 8])
def test_tensor_parallel_steps_match_jax(tensor):
    """tensor=8 over 4 KV heads: each shard's wqkv holds every KV column,
    whose gradients are summed over the shards."""
    name = "tiny-llama"
    jcfg, cfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jstate, jstep, jm_ = _jax_sharded_state(jcfg, tensor)
    host = jax.tree.map(np.asarray, jstate)
    mesh = tmesh.build_mesh(MeshConfig(tensor=tensor), [CPU] * tensor)
    state = train_state_from_numpy(host.params, host.opt_state, 0, cfg, CPU,
                                   mesh=mesh)
    assert isinstance(state.params["layers"]["wqkv"], Sharded)
    batches = [_tokens(2, 33, cfg.vocab_size, seed=10 + s) for s in range(3)]
    with jm_:
        jstate, jlosses = _jax_steps(jstate, batches, jcfg, jstep)
    state, losses = _port_steps(state, batches, cfg)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _close_params(_whole_params(state, cfg), _flat(jstate.params), "param")
    wqkv = state.params["layers"]["wqkv"]
    assert len(wqkv.distinct()) == tensor
    if cfg.num_kv_heads % tensor:
        hq = cfg.num_heads // tensor * cfg.head_dim
        kv = [p[..., hq:].detach() for p in wqkv.distinct()]
        assert all(torch.equal(k, kv[0]) for k in kv[1:])


def test_sum_tied_grads_sums_distinct_replicas():
    """A replicated leaf whose two parts are distinct tensors (replicas
    on two cards): each got the gradient of its own uses; after the tie
    both hold the sum. Disjoint parts are left alone."""
    mesh = tmesh.build_mesh(MeshConfig(tensor=2), [CPU] * 2)
    a = torch.ones(3, requires_grad=True)
    b = a.detach().clone().requires_grad_(True)
    (2 * a).sum().backward()
    (5 * b).sum().backward()
    rep = Sharded((a, b), (1,), mesh)
    sum_tied_grads(rep, (None,))
    assert torch.equal(a.grad, torch.full((3,), 7.0))
    assert torch.equal(b.grad, torch.full((3,), 7.0))
    c, d = (torch.zeros(2, requires_grad=True) for _ in range(2))
    c.grad, d.grad = torch.ones(2), 2 * torch.ones(2)
    sum_tied_grads(Sharded((c, d), (2,), mesh), ("tensor",))
    assert torch.equal(c.grad, torch.ones(2))
    assert torch.equal(d.grad, 2 * torch.ones(2))


@pytest.mark.parametrize("case", [
    dict(),
    dict(window=5),
    dict(q_offset=(3, 0), kv_len=(9, 4)),
], ids=["causal", "window", "ragged"])
def test_flash_attention_fn_grads_on_cpu(case):
    gen = torch.Generator().manual_seed(0)
    b, sq, sk, h, kvh, d = 2, 6, 9, 4, 2, 32
    q0 = torch.randn(b, sq, h, d, generator=gen)
    k0, v0 = (torch.randn(b, sk, kvh, d, generator=gen) for _ in range(2))
    dout = torch.randn(b, sq, h, d, generator=gen)
    kw = dict(causal=True, window=case.get("window"),
              q_offset=(torch.tensor(case["q_offset"], dtype=torch.int32)
                        if "q_offset" in case else None),
              kv_len=(torch.tensor(case["kv_len"], dtype=torch.int32)
                      if "kv_len" in case else None))
    grads = []
    before = tatt.flash_attention.backward_recomputes
    for via_fn in (True, False):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        if via_fn:
            out = tatt.FlashAttentionFn.apply(
                q, k, v, kw["causal"], kw["q_offset"], kw["kv_len"],
                kw["window"])
            assert out.grad_fn is not None
        else:
            out = tatt.flash_attention_ref(q, k, v, **kw)
        out.backward(dout)
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    assert tatt.flash_attention.backward_recomputes == before + 1
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert grads[0][1].abs().max() > 0
