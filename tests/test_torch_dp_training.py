"""Data-parallel training in the port against the JAX package on the
CPU: the [B, S] batch split over the data blocks of a `data` / `fsdp`
mesh (alone, with `tensor` and with `stage`), three AdamW steps from one
JAX state crossed through numpy, against the JAX package's
`make_sharded_train_step` (and `make_pipeline_train_step` under a stage
axis) on `jax.devices()[:n]`.

What is held: the losses at rtol 1e-4 (one mean over the global batch's
tokens, whatever the blocks), each final param leaf within 1e-4 of its
largest magnitude save at most one entry in 10^4, each within one
learning rate a step (as tests/test_torch_training.py holds tensor=2);
the replicated leaves one stored tensor per device, so every block's
gradient lands in it; tiny-moe's loss at data=2 x expert=2 equal to the
JAX step's (the router's capacity and aux term over the global batch);
and the trainer's loop at data=2 giving data=1's losses.
"""

import functools
import logging

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
from ggrmcp_tpu.parallel import pipeline as jpipe
from ggrmcp_tpu_torch.core.config import MeshConfig, TrainingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.models import trainer as ttrainer
from ggrmcp_tpu_torch.models import training as ttrain
from ggrmcp_tpu_torch.models.convert import train_state_from_numpy
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.parallel import pipeline as tpipe
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
LR = 3e-4  # make_optimizer's default in both packages


def _tokens(batch, seq, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int32)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    full = {"data": 1, "tensor": 1, **axes}
    return (jmesh.build_mesh(JMesh(**full), jax.devices()[:n]),
            tmesh.build_mesh(MeshConfig(**full), [CPU] * n))


def _states(jmod, jcfg, cfg, jmesh_, mesh, staged, key=4):
    """One JAX state, placed on the JAX mesh by its specs, and the port's
    crossed from it onto the port's mesh."""
    jstate = jtrain.init_train_state(jax.random.PRNGKey(key), jcfg)
    host = jax.tree.map(np.asarray, jstate)
    state = train_state_from_numpy(host.params, host.opt_state, 0, cfg, CPU,
                                   mesh=mesh)
    if staged:
        params = jpipe.shard_params_pp(jstate.params, jcfg, jmesh_)
        step, _ = jpipe.make_pipeline_train_step(jcfg, jmesh_)
    else:
        params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(
                jmesh_, jmesh.compatible_spec(s, np.shape(x), jmesh_))),
            jstate.params, jmod.param_specs(jcfg))
        step, _ = jtrain.make_sharded_train_step(jcfg, jmesh_)
    jstate = jtrain.TrainState(params, jax.device_put(jstate.opt_state),
                               jstate.step)
    return jstate, step, state


def _steps(jstate, jstep, jmesh_, state, step, batches):
    jlosses, losses = [], []
    for b in batches:
        with jmesh_:
            jstate, jloss = jstep(jstate, jnp.asarray(b))
        state, loss = step(state, torch.from_numpy(b))
        jlosses.append(float(jloss))
        losses.append(loss.item())
    return jstate, jlosses, state, losses


@pytest.mark.parametrize("axes", [
    dict(data=2), dict(fsdp=2), dict(data=2, tensor=2),
    dict(data=2, stage=2), dict(tensor=3), dict(sequence=2),
], ids=["data2", "fsdp2", "data2_tensor2", "data2_stage2", "tensor3",
        "sequence2"])
def test_three_steps_match_jax(axes):
    """tensor=3 splits no dim of tiny-llama (every block whole: a replica
    computed once per device must not multiply its gradient); sequence=2
    replicates, as the reference's trainer places it."""
    name = "tiny-llama"
    jcfg, cfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jmesh_, mesh = _meshes(axes)
    staged = "stage" in axes
    jstate, jstep, state = _states(jl, jcfg, cfg, jmesh_, mesh, staged)
    step = (tpipe.make_pipeline_train_step(cfg, mesh) if staged
            else functools.partial(ttrain.train_step, cfg=cfg))
    batches = [_tokens(4, 17, cfg.vocab_size, 30 + s) for s in range(3)]
    jstate, jlosses, state, losses = _steps(jstate, jstep, jmesh_, state,
                                            step, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = ttrainer.state_tensors(state, cfg)[0]
    for leaf_name, w in _flat(jstate.params).items():
        w = np.asarray(w, np.float64)
        diff = np.abs(np.asarray(got[leaf_name], np.float64) - w)
        off = int((diff > 1e-4 * np.abs(w).max()).sum())
        assert off <= diff.size * 1e-4, f"{leaf_name}: {off} entries off"
        assert diff.max() <= 3 * LR, f"{leaf_name}: {diff.max()}"
    # Replicated over the data blocks: one stored tensor a stage.
    norm = state.params["layers"]["attn_norm"]
    assert isinstance(norm, Sharded)
    assert len(norm.distinct()) == axes.get("stage", 1)


def test_moe_loss_is_batch_global_at_data2():
    """tiny-moe at data=2 x expert=2: routing once over both blocks' rows
    gives the JAX sharded step's loss (a block routed alone would keep
    other pairs), and data=1's."""
    name = "tiny-moe"
    jcfg, cfg = jm.CONFIGS[name], tm.CONFIGS[name]
    toks = _tokens(4, 13, cfg.vocab_size, 11)
    losses = []
    for axes in (dict(data=2, expert=2), dict(expert=2)):
        jmesh_, mesh = _meshes(axes)
        jstate, jstep, state = _states(jm, jcfg, cfg, jmesh_, mesh, False, 5)
        with jmesh_:
            _, jloss = jstep(jstate, jnp.asarray(toks))
        _, loss = ttrain.train_step(state, torch.from_numpy(toks), cfg)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_trainer_loop_at_data2_matches_data1(caplog):
    """The `train` loop's own data stream, at data=2 (a TrainingConfig
    mesh, the CPU repeated) and data=1: the same losses, step for step."""
    logs = []
    for mesh in (MeshConfig(tensor=1, data=2), MeshConfig(tensor=1)):
        caplog.clear()
        cfg = TrainingConfig(model="tiny-llama", steps=3, batch_size=4,
                             seq_len=17, log_every_steps=1, mesh=mesh)
        with caplog.at_level(logging.INFO, logger="ggrmcp.torch.models"):
            state = ttrainer.train(cfg, device="cpu")
        assert state.step == 3
        logs.append([float(r.getMessage().split("loss=")[1].split()[0])
                     for r in caplog.records if "loss=" in r.getMessage()])
    assert len(logs[0]) == 3
    np.testing.assert_allclose(logs[0], logs[1], rtol=1e-5)
