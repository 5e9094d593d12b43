"""Every mesh axis across processes: the port's multi-process training
(parallel/distributed.py `global_mesh` and its groups, the collectives'
cross-process forms) against the JAX package's global-mesh training on
the CPU.

One pair of gloo processes (tests/torch_distributed_worker.py) takes
every run in turn, each run three AdamW steps of a tiny model from one
JAX state (through numpy) and the same batches; the JAX package takes
the same steps with its `make_sharded_train_step` (or
`make_pipeline_train_step` under a stage axis) on `jax.devices()[:n]`
with the same mesh. The runs: tiny-llama at tensor=4 over two
processes (two shards each), tiny-moe at data=2 (its routing and aux
loss over the global batch: the pairs dropped and the aux loss each step
equal the reference's), tiny-moe at expert=4 (an expert bank a
coordinate, two a process), tiny-llama at stage=2 (one stage a process,
its hops sends and receives) and at sequence=2 (each process its
replica); tests/test_torch_process_groups.py runs four processes with
this file's helpers, one coordinate each. Held as
tests/test_torch_distributed.py holds data=4: the losses at rtol 1e-4;
each final leaf within 1e-4 of its largest magnitude save one entry in
10^4 and within three learning rates; a block several processes hold
bitwise equal on all of them. Two planted faults: the tensor group's
gradient sum in `copy_in`'s backward skipped fails the params bound; the
stage group's reduce skipped leaves the two stages' copies of the
embedding, the final norm and the head apart. A last run in which one
process exits before its first step makes the other's first collective
raise: no process hangs or goes on alone.
"""

import json
import os
import socket
import subprocess
import sys

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
from ggrmcp_tpu.ops.quant import embed_lookup as jembed
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu.parallel import pipeline as jpipe
from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.parallel import collectives
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
LR = 3e-4
STEPS = 3
# Batch shape and first seed by model; tiny-moe's batches make the
# capacity drop pairs at every step.
SHAPE = {"tiny-llama": (4, 17), "tiny-moe": (4, 33)}
SEED = {"tiny-llama": 40, "tiny-moe": 80}
RUNS = {
    "tensor4": dict(model="tiny-llama", axes=dict(tensor=4)),
    "moe_data2": dict(model="tiny-moe", axes=dict(data=2)),
    "moe_expert4": dict(model="tiny-moe", axes=dict(expert=4)),
    "stage2": dict(model="tiny-llama", axes=dict(stage=2)),
    "sequence2": dict(model="tiny-llama", axes=dict(sequence=2)),
    "tensor4_fault": dict(model="tiny-llama", axes=dict(tensor=4),
                          fault="tensor_backward"),
    "stage2_fault": dict(model="tiny-llama", axes=dict(stage=2),
                         fault="stage_reduce"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _jax_state(name):
    fam = jm if name in jm.CONFIGS else jl
    cfg = fam.CONFIGS[name]
    return fam, cfg, jtrain.init_train_state(jax.random.PRNGKey(4), cfg)


def _routing(params, cfg, tokens):
    """The reference's routing of `tokens`, layer by layer: the pairs
    its capacity drops and the mean aux loss (jm._layer unrolled, with
    `route` watched)."""
    kept, route = [], jm.route

    def watch(*args, **kwargs):
        out = route(*args, **kwargs)
        kept.append(int(np.asarray(out[0]).sum()))
        return out

    jm.route = watch
    try:
        b, s = tokens.shape
        x = jembed(params["embed"], tokens, cfg.jnp_dtype)
        pos = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))
        auxes = []
        for i in range(cfg.num_layers):
            lp = jax.tree.map(lambda a: a[i], params["layers"])
            x, _, aux = jm._layer(x, lp, cfg, pos, None, None, None, None)
            auxes.append(float(aux))
    finally:
        jm.route = route
    pairs = b * s * cfg.experts_per_token
    return sum(pairs - k for k in kept), float(np.mean(auxes))


def _jax_run(run, batches):
    """The JAX package's three steps on the run's mesh: losses, final
    params and, for MoE, each step's dropped pairs and aux loss."""
    fam, cfg, state = _jax_state(run["model"])
    axes = {"data": 1, "tensor": 1, **run["axes"]}
    n = int(np.prod(list(axes.values())))
    mesh = jmesh.build_mesh(JMesh(**axes), jax.devices()[:n])
    if axes.get("stage", 1) > 1:
        params = jpipe.shard_params_pp(state.params, cfg, mesh)
        step, _ = jpipe.make_pipeline_train_step(cfg, mesh)
    else:
        params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(
                mesh, jmesh.compatible_spec(s, np.shape(x), mesh))),
            state.params, fam.param_specs(cfg))
        step, _ = jtrain.make_sharded_train_step(cfg, mesh)
    state = jtrain.TrainState(params, jax.device_put(state.opt_state),
                              state.step)
    losses, dropped, aux = [], [], []
    for b in batches:
        if fam is jm:
            d, a = _routing(jax.device_get(state.params), cfg,
                            jnp.asarray(b[:, :-1]))
            dropped.append(d)
            aux.append(a)
        with mesh:
            state, loss = step(state, jnp.asarray(b))
        losses.append(float(loss))
    return dict(losses=losses, params=_flat(jax.tree.map(
        np.asarray, state.params)), dropped=dropped, aux=aux)


def _start(runs, n) -> list:
    """`n` processes of the worker over a local coordinator, each to take
    `runs` in turn."""
    spec = dict(device="cpu", runs=runs)
    env = {**os.environ, "GGRMCP_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "GGRMCP_NUM_PROCESSES": str(n)}
    return [subprocess.Popen(
        [sys.executable, WORKER, json.dumps(spec)],
        env={**env, "GGRMCP_PROCESS_ID": str(pid)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(n)]


def run_processes(tmp, runs: dict, n: int, extra=()) -> dict:
    """`runs` (then the `extra` runs, which write nothing) over `n`
    processes, started first, the JAX references of the runs without a
    fault computed while they run: dict(want, got, outs, codes), `got`
    each run's readings by rank."""
    batches = {}
    for name, (b, s) in SHAPE.items():
        _, cfg, state = _jax_state(name)
        np.savez(tmp / f"{name}.npz", **_flat(jax.tree.map(
            np.asarray, state.params)))
        batches[name] = np.stack([
            np.random.default_rng(SEED[name] + i).integers(
                0, cfg.vocab_size, (b, s), dtype=np.int32)
            for i in range(STEPS)])
        np.save(tmp / f"{name}.npy", batches[name])

    def placed(run, out):
        return dict(run, init=str(tmp / f"{run['model']}.npz"),
                    batches=str(tmp / f"{run['model']}.npy"),
                    out=str(tmp / out))
    procs = _start([placed(run, key) for key, run in runs.items()]
                   + [placed(run, f"extra{i}") for i, run in
                      enumerate(extra)], n)
    try:
        want = {key: _jax_run(run, batches[run["model"]])
                for key, run in runs.items() if "fault" not in run}
        outs = [p.communicate(timeout=240)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {}
    for key in runs:
        for rank, out in enumerate(outs):
            assert f"OK run={tmp / key} process={rank}" in out, (
                f"{key}, process {rank}:\n{out[-4000:]}")
        got[key] = []
        for rank in range(n):
            with np.load(tmp / f"{key}{rank}.npz") as f:
                got[key].append({k: f[k] for k in f.files})
    return dict(want=want, got=got, outs=outs,
                codes=[p.returncode for p in procs])


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """The pair of processes over every run and, last, one process
    exiting before its first step."""
    return run_processes(
        tmp_path_factory.mktemp("axes"), RUNS, 2,
        extra=[dict(model="tiny-llama", axes=dict(tensor=2),
                    exit_before_step=1)])


def _params_off(got, want) -> list:
    """The leaves outside the params bound, with why."""
    off = []
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        diff = np.abs(np.asarray(got[f"p.{name}"], np.float64) - w)
        n = int((diff > 1e-4 * np.abs(w).max()).sum())
        if n > diff.size * 1e-4 or diff.max() > 3 * LR:
            off.append(f"{name}: {n} entries off, max {diff.max():.3g}")
    return off


def parity(runs: dict) -> list:
    return [k for k, run in runs.items() if "fault" not in run]


def check_losses(got: list, want: dict) -> None:
    for g in got:
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-4)


def check_blocks(got: list) -> dict:
    """Every block several processes hold bitwise equal on all of them,
    and the whole final params equal on every process; returns block ->
    the ranks holding it."""
    held = {}
    for rank, g in enumerate(got):
        for k in g:
            if k.startswith("h."):
                held.setdefault(k, []).append(rank)
    for k, ranks in held.items():
        for rank in ranks[1:]:
            assert np.array_equal(got[ranks[0]][k], got[rank][k]), k
    whole = [k for k in got[0] if k.startswith("p.")]
    assert whole and all(np.array_equal(got[0][k], g[k])
                         for g in got[1:] for k in whole)
    return held


def check_layout(got: list, sizes: list, local: list) -> None:
    """Each process saw the mesh's sizes, its own box and consecutive
    owners, as many coordinates each."""
    for rank, g in enumerate(got):
        seen = json.loads(str(g["seen"]))
        assert seen["rank"] == rank and seen["sizes"] == sizes
        assert seen["local_sizes"] == local
        n = len(seen["owners"])
        assert seen["owners"] == [p for p in range(len(got))
                                  for _ in range(n // len(got))]


PARITY = parity(RUNS)


@pytest.mark.parametrize("key", PARITY)
def test_losses_match_jax(processes, key):
    check_losses(processes["got"][key], processes["want"][key])


@pytest.mark.parametrize("key", PARITY)
def test_params_match_jax(processes, key):
    for got in processes["got"][key]:
        assert not _params_off(got, processes["want"][key]["params"])


@pytest.mark.parametrize("key", PARITY)
def test_blocks_held_twice_are_bitwise_equal(processes, key):
    held = check_blocks(processes["got"][key])
    # Every leaf is held by both processes unless an axis splits it.
    if key == "sequence2":
        assert all(len(ranks) == 2 for ranks in held.values())


@pytest.mark.parametrize("key,layout", [
    ("tensor4", ([1, 1, 4, 1, 1, 1], [1, 1, 2, 1, 1, 1])),
    ("moe_data2", ([2, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1])),
    ("moe_expert4", ([1, 1, 1, 1, 4, 1], [1, 1, 1, 1, 2, 1])),
    ("stage2", ([1, 1, 1, 1, 1, 2], [1, 1, 1, 1, 1, 1])),
    ("sequence2", ([1, 1, 1, 2, 1, 1], [1, 1, 1, 1, 1, 1])),
])
def test_each_axis_crosses_the_processes(processes, key, layout):
    check_layout(processes["got"][key], *layout)


@pytest.mark.parametrize("key", ["moe_data2", "moe_expert4"])
def test_moe_routing_is_batch_global(processes, key):
    """The pairs the capacity drops and the aux loss, each step, as the
    reference routes the global batch: summed over the processes that
    hold different rows (data=2), as each process routes it where both
    hold every row (expert=4). The batches are sized so that the
    capacity drops pairs."""
    want = processes["want"][key]
    assert min(want["dropped"]) > 0
    a, b = processes["got"][key]
    dropped = (a["dropped"] + b["dropped"] if key == "moe_data2"
               else a["dropped"])
    assert list(dropped) == want["dropped"]
    if key == "moe_expert4":
        assert list(b["dropped"]) == want["dropped"]
    for got in (a, b):
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)


def test_tensor_backward_without_its_sum_fails_the_bound(processes):
    """The planted fault: `copy_in`'s backward left without the tensor
    group's sum, each process's replicated activations then carry only
    its own shards' gradient."""
    for got in processes["got"]["tensor4_fault"]:
        assert _params_off(got, processes["want"]["tensor4"]["params"])


def test_stage_reduce_skipped_parts_the_replicas(processes):
    """The planted fault of the stage axis: the stage group's reduce
    skipped, the embedding, final norm and head that both stages hold
    each take only the gradient of the stage that used them, and the two
    processes' copies part."""
    a, b = processes["got"]["stage2_fault"]
    both = [k for k in a if k.startswith("h.") and k in b]
    assert both and any(not np.array_equal(a[k], b[k]) for k in both)


def test_a_process_gone_makes_the_other_raise(processes):
    """The last run: process 1 exits before its first step; process 0's
    first collective raises (gloo sees the peer gone), so it exits with
    an error and no process trains alone."""
    codes, outs = processes["codes"], processes["outs"]
    assert codes[1] == 5, outs[1][-2000:]
    assert codes[0] not in (0, None), outs[0][-2000:]
    assert "Traceback" in outs[0] and "OK run=" in outs[0]
    assert "extra0 process=0" not in outs[0]


def test_a_group_no_process_formed_raises():
    """A mesh split over processes but built without `global_mesh` has no
    groups: a collective across its processes raises, one process's own
    needs none."""
    mesh = tmesh.build_mesh(MeshConfig(data=1, tensor=4), [CPU] * 4,
                            owners=[0, 0, 1, 1])
    with pytest.raises(RuntimeError, match="no process group"):
        collectives.group_for(mesh, (0, 1))
    with pytest.raises(RuntimeError, match="no process group"):
        collectives.axis_group(mesh, ("tensor",))
    assert collectives.group_for(mesh, (0,)) is None
