"""The training half of pipeline parallelism in the port
(parallel/pipeline.py), mirroring `tests/test_pipeline.py` case by case
against the JAX package on its CPU mesh (`jax.devices()[:n]` of the
suite's forced 8-device platform; the port's mesh is the CPU repeated n
times), on one weight tree crossed through numpy:

- the staged forward's logits at stage 4, at stage 2 x tensor 2, with
  more microbatches than stages, and at one stage over tensor 2, each
  within 2e-4 of the JAX package's `pipeline_forward` and of the
  unstaged forward;
- the reference's two errors: a batch the microbatches do not divide,
  layers the stages do not divide;
- a staged train step's loss at the unstaged `lm_loss` (rtol 1e-3, the
  reference's bound), then three steps at stage 2 and at stage 4
  against the JAX `make_pipeline_train_step`: losses at rtol 1e-4, each
  final param leaf elementwise within 1e-4 of its largest magnitude,
  save at most one entry in 10^4, each within one learning rate a step
  (an entry whose gradient sits at summation noise can take AdamW's
  step another way);
- sparse MoE at stage 2 x expert 2: logits against the JAX pipeline
  (each microbatch routed on its own, as there) within 2e-3, and a
  staged train step's loss (router aux included) against the JAX one at
  rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.models import moe as jm
from ggrmcp_tpu.models import training as jtrain
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.parallel import pipeline as jpipe
from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models import trainer as ttrainer
from ggrmcp_tpu_torch.models import training as ttrain
from ggrmcp_tpu_torch.models.convert import (
    params_from_numpy,
    train_state_from_numpy,
)
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel import pipeline as tpipe
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
NAME = "tiny-llama"  # 4 layers, float32
CFG, JCFG = tl.CONFIGS[NAME], jl.CONFIGS[NAME]
ATOL = 2e-4
LR = 3e-4


def _meshes(**axes):
    n = int(np.prod(list(axes.values())))
    full = {"tensor": 1, **axes}
    return (jmesh.build_mesh(JMesh(data=1, **full), jax.devices()[:n]),
            tmesh.build_mesh(MeshConfig(**full), [CPU] * n))


def _tokens(batch, seq=16, seed=7, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(0), JCFG)


def _cross(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _forwards(jparams, axes, batch, **kw):
    jmesh_, mesh = _meshes(**axes)
    toks = _tokens(batch)
    with jmesh_:
        want = jax.jit(lambda p, t: jpipe.pipeline_forward(
            p, JCFG, t, jmesh_, **kw))(
                jpipe.shard_params_pp(jparams, JCFG, jmesh_),
                jnp.asarray(toks))
    params = tpipe.shard_params_pp(_cross(jparams), CFG, mesh)
    with torch.no_grad():
        got = tpipe.pipeline_forward(params, CFG, torch.from_numpy(toks),
                                     mesh, **kw)
    unstaged, _ = jl.forward(jparams, JCFG, jnp.asarray(toks))
    return got.numpy(), np.asarray(want), np.asarray(unstaged)


class TestPipelineForward:
    @pytest.mark.parametrize("axes,batch,kw", [
        (dict(stage=4), 4, {}),
        (dict(stage=2, tensor=2), 4, {}),
        (dict(stage=2), 8, dict(num_microbatches=4)),
        (dict(tensor=2), 4, {}),
    ], ids=["stage4", "pp_x_tp", "more_microbatches", "single_stage"])
    def test_matches_jax_pipeline_and_unstaged(self, jparams, axes, batch,
                                               kw):
        got, want, unstaged = _forwards(jparams, axes, batch, **kw)
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(got, unstaged, rtol=ATOL, atol=ATOL)

    def test_batch_not_divisible_raises(self, jparams):
        _, mesh = _meshes(stage=4)
        params = tpipe.shard_params_pp(_cross(jparams), CFG, mesh)
        with pytest.raises(ValueError, match="not divisible"):
            tpipe.pipeline_layers(params["layers"], CFG,
                                  torch.zeros(3, 8, CFG.hidden_dim),
                                  torch.zeros(3, 8, dtype=torch.long), mesh)

    def test_layers_not_divisible_raises(self, jparams):
        mesh = tmesh.build_mesh(MeshConfig(stage=8, tensor=1), [CPU] * 8)
        with pytest.raises(ValueError, match="layers not divisible"):
            tpipe.pipeline_layers(_cross(jparams)["layers"], CFG,
                                  torch.zeros(8, 8, CFG.hidden_dim),
                                  torch.zeros(8, 8, dtype=torch.long), mesh)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(
                value.detach() if isinstance(value, torch.Tensor) else value)
    return out


def _staged_states(jcfg, cfg, jmesh_, mesh, key):
    jstate = jtrain.init_train_state(jax.random.PRNGKey(key), jcfg)
    host = jax.tree.map(np.asarray, jstate)
    state = train_state_from_numpy(host.params, host.opt_state, 0, cfg, CPU,
                                   mesh=mesh)
    jstate = jtrain.TrainState(
        jpipe.shard_params_pp(jstate.params, jcfg, jmesh_),
        jstate.opt_state, jstate.step)
    return jstate, state


class TestPipelineTraining:
    def test_staged_train_step_matches_reference_loss(self, jparams):
        jmesh_, mesh = _meshes(stage=2)
        toks = _tokens(4, seq=17)
        ref_loss = jtrain.lm_loss(jparams, JCFG, jnp.asarray(toks))
        host = jax.tree.map(np.asarray, jparams)
        state = ttrain.make_train_state(params_from_numpy(host, CPU), CFG,
                                        mesh=mesh)
        step = tpipe.make_pipeline_train_step(CFG, mesh)
        state, loss = step(state, torch.from_numpy(toks))
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-3)
        assert state.step == 1
        _, loss2 = step(state, torch.from_numpy(toks))
        assert loss2.item() != loss.item() and np.isfinite(loss2.item())

    @pytest.mark.parametrize("stages", [2, 4])
    def test_three_steps_match_jax(self, stages):
        jmesh_, mesh = _meshes(stage=stages)
        jstate, state = _staged_states(JCFG, CFG, jmesh_, mesh, 3)
        jstep, _ = jpipe.make_pipeline_train_step(JCFG, jmesh_)
        step = tpipe.make_pipeline_train_step(CFG, mesh)
        jlosses, losses = [], []
        for s in range(3):
            toks = _tokens(4, seq=17, seed=20 + s)
            with jmesh_:
                jstate, jloss = jstep(jstate, jnp.asarray(toks))
            state, loss = step(state, torch.from_numpy(toks))
            jlosses.append(float(jloss))
            losses.append(loss.item())
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        got = ttrainer.state_tensors(state, CFG)[0]
        for name, w in _flat(jstate.params).items():
            diff = np.abs(np.asarray(got[name], np.float64) - w)
            off = int((diff > 1e-4 * np.abs(w).max()).sum())
            assert off <= diff.size * 1e-4, f"{name}: {off} entries off"
            assert diff.max() <= 3 * LR, f"{name}: {diff.max()}"


class TestPipelineMoE:
    def test_moe_pipeline_matches_jax(self):
        name = "tiny-moe"
        jcfg, cfg = jm.CONFIGS[name], tm.CONFIGS[name]
        jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
        jmesh_, mesh = _meshes(stage=2, expert=2)
        toks = _tokens(4, seq=12, seed=9, vocab=cfg.vocab_size)
        with jmesh_:
            want = jax.jit(lambda p, t: jpipe.pipeline_forward(
                p, jcfg, t, jmesh_))(
                    jpipe.shard_params_pp(jparams, jcfg, jmesh_),
                    jnp.asarray(toks))
        params = tpipe.shard_params_pp(_cross(jparams), cfg, mesh)
        with torch.no_grad():
            got = tpipe.pipeline_forward(params, cfg, torch.from_numpy(toks),
                                         mesh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)

    def test_moe_staged_step_loss_matches_jax(self):
        name = "tiny-moe"
        jcfg, cfg = jm.CONFIGS[name], tm.CONFIGS[name]
        jmesh_, mesh = _meshes(stage=2, expert=2)
        jstate, state = _staged_states(jcfg, cfg, jmesh_, mesh, 5)
        toks = _tokens(4, seq=13, seed=11, vocab=cfg.vocab_size)
        jstep, _ = jpipe.make_pipeline_train_step(jcfg, jmesh_)
        with jmesh_:
            _, jloss = jstep(jstate, jnp.asarray(toks))
        _, loss = tpipe.make_pipeline_train_step(cfg, mesh)(
            state, torch.from_numpy(toks))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
