"""The port's multi-process runtime (ggrmcp_tpu_torch/parallel/
distributed.py) against the JAX package's (ggrmcp_tpu/parallel/
distributed.py, tests/test_distributed.py, tests/test_multihost.py) on
the CPU.

In process: `initialize` is single-process when nothing is configured
or one process is, takes GGRMCP_COORDINATOR / GGRMCP_NUM_PROCESSES /
GGRMCP_PROCESS_ID with explicit arguments first, and picks its backend
by the stated rule (gloo on the CPU and on a shared card, nccl on a card
of its own); `global_mesh` covers the devices; a mesh split over
processes gives each its own blocks, and one split any other way is
refused.

Two processes (tests/torch_distributed_worker.py), each holding 2 CPU
coordinates, so global data=4 as the reference's workers hold 4 host
devices each: a range summed over the data axis across them exactly, and
three tiny-llama AdamW steps over the global mesh against the JAX
package's `make_sharded_train_step` on `jax.devices()[:4]` for the same
state and batches: losses at rtol 1e-4, every final leaf within 1e-4 of
its largest magnitude save one entry in 10^4 and within three learning
rates (tests/test_torch_dp_training.py's tolerances), and the two
processes' params bitwise equal.
"""

import datetime
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
from ggrmcp_tpu.models import training as jtrain
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.parallel import collectives, distributed
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
ENV = ("GGRMCP_COORDINATOR", "GGRMCP_NUM_PROCESSES", "GGRMCP_PROCESS_ID")
LR = 3e-4
CPU = torch.device("cpu")


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


# -- initialize and the backend rule -------------------------------------------


class TestInitialize:
    def test_single_process_when_unconfigured(self, monkeypatch):
        for var in ENV:
            monkeypatch.delenv(var, raising=False)
        assert distributed.initialize() is False

    def test_one_process_is_single(self, monkeypatch):
        for var in ENV:
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: pytest.fail(f"joined: {kw}"))
        assert distributed.initialize("127.0.0.1:1", 1, 0) is False

    def test_env_autodetection_feeds_torch(self, monkeypatch):
        monkeypatch.setattr(distributed, "_device", None)
        seen = {}
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: seen.update(kw))
        monkeypatch.setenv("GGRMCP_COORDINATOR", "coord:1234")
        monkeypatch.setenv("GGRMCP_NUM_PROCESSES", "2")
        monkeypatch.setenv("GGRMCP_PROCESS_ID", "1")
        assert distributed.initialize(device="cpu") is True
        assert seen == {"backend": "gloo", "init_method": "tcp://coord:1234",
                        "world_size": 2, "rank": 1,
                        "timeout": datetime.timedelta(
                            seconds=distributed.TIMEOUT_S)}
        assert distributed.local_device() == CPU

    def test_explicit_args_beat_env(self, monkeypatch):
        monkeypatch.setattr(distributed, "_device", None)
        seen = {}
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: seen.update(kw))
        monkeypatch.setenv("GGRMCP_COORDINATOR", "env:1")
        monkeypatch.setenv("GGRMCP_NUM_PROCESSES", "8")
        monkeypatch.setenv("GGRMCP_PROCESS_ID", "5")
        assert distributed.initialize(
            coordinator_address="flag:2", num_processes=2, process_id=0,
            device="cpu") is True
        assert seen["init_method"] == "tcp://flag:2"
        assert (seen["world_size"], seen["rank"]) == (2, 0)

    @pytest.mark.parametrize("args", [
        dict(coordinator_address="h:1"),
        dict(num_processes=2, process_id=0),
        dict(coordinator_address="h:1", num_processes=2, process_id=2),
    ], ids=["no-count", "no-coordinator", "id-out-of-range"])
    def test_incomplete_configuration_raises(self, args, monkeypatch):
        for var in ENV:
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: pytest.fail(f"joined: {kw}"))
        with pytest.raises(ValueError):
            distributed.initialize(device="cpu", **args)

    def test_a_card_is_asked_for_never_the_cpu(self, monkeypatch):
        """Without a device a process asks for its card; with none here
        it raises, and no group forms on the CPU instead."""
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: pytest.fail(f"joined: {kw}"))
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.initialize("h:1", 2, 0)

    @pytest.mark.parametrize("device,pid,want", [
        ("cpu", 1, ("gloo", "cpu")),
        ("cuda:0", 1, ("gloo", "cuda:0")),
        (None, 1, ("nccl", "cuda:1")),
        ("cuda", 0, ("nccl", "cuda:0")),
    ], ids=["cpu", "shared-card", "own-card", "own-card-named-cuda"])
    def test_backend_rule(self, device, pid, want):
        assert distributed.placement(device, pid) == want


class TestMesh:
    def test_global_mesh_covers_the_devices(self):
        mesh = distributed.global_mesh(MeshConfig(tensor=2, data=0),
                                       [CPU] * 8)
        assert mesh.size == 8 and not mesh.spans_processes
        assert (mesh.shape["tensor"], mesh.shape["data"]) == (2, 4)

    @pytest.mark.parametrize("axes,rank,local,rows", [
        (dict(data=4), 1, dict(data=2), slice(4, 8)),
        (dict(data=2, tensor=2), 0, dict(data=1, tensor=2), slice(0, 4)),
        (dict(data=2, fsdp=2), 1, dict(data=1, fsdp=2), slice(4, 8)),
        (dict(fsdp=4), 1, dict(fsdp=2), slice(4, 8)),
        (dict(tensor=4), 1, dict(tensor=2), slice(0, 8)),
        (dict(expert=4), 1, dict(expert=2), slice(0, 8)),
        (dict(sequence=2, stage=2), 1, dict(stage=2), slice(0, 8)),
    ], ids=["data4", "data2-tensor2", "data2-fsdp2", "fsdp4", "tensor4",
            "expert4", "sequence2-stage2"])
    def test_a_process_holds_its_blocks(self, axes, rank, local, rows):
        mesh = tmesh.build_mesh(MeshConfig(**{"tensor": 1, **axes}),
                                [CPU] * 4, owners=[0, 0, 1, 1], rank=rank)
        assert mesh.spans_processes
        assert mesh.local_indices() == [2 * rank, 2 * rank + 1]
        mine = mesh.local()
        want = tmesh.build_mesh(MeshConfig(**{"tensor": 1, **local}),
                                [CPU] * 2)
        assert mine.sizes == want.sizes and mine.owners is None
        assert tmesh.process_rows(mesh, 8) == rows
        assert mesh.distinct_devices() == [CPU]
        with pytest.raises(ValueError, match="processes"):
            tmesh.check_data_placement(mesh)

    @pytest.mark.parametrize("axes,owners", [
        (dict(data=4), [0, 1, 0, 1]),
        (dict(data=4), [0, 0, 0, 1]),
        (dict(data=2, fsdp=3), [0, 0, 1, 1, 2, 2]),
    ], ids=["interleaved", "uneven", "fsdp-straddled"])
    def test_other_splits_are_refused(self, axes, owners):
        with pytest.raises(ValueError, match="process"):
            tmesh.build_mesh(MeshConfig(**{"tensor": 1, **axes}),
                             [CPU] * len(owners), owners=owners)

    def test_a_batch_the_blocks_do_not_divide_is_refused(self):
        mesh = tmesh.build_mesh(MeshConfig(data=4, tensor=1), [CPU] * 4,
                                owners=[0, 0, 1, 1])
        with pytest.raises(ValueError, match="divide"):
            tmesh.process_rows(mesh, 6)

    def test_every_group_takes_the_timeout(self, monkeypatch):
        """`form_groups` over four processes at data=2 x tensor=2, one
        coordinate each: the batch and tensor pairs, created in one order
        on every process, each with the default group's timeout; this
        process keeps its own."""
        made = []
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
        monkeypatch.setattr(
            torch.distributed, "new_group",
            lambda ranks, timeout: made.append((tuple(ranks), timeout))
            or tuple(ranks))
        mesh = tmesh.build_mesh(MeshConfig(data=2, tensor=2), [CPU] * 4,
                                owners=[0, 1, 2, 3], rank=1)
        groups = distributed.form_groups(mesh)
        assert [ranks for ranks, _ in made] == [(0, 1), (0, 2), (1, 3),
                                                (2, 3)]
        assert {t for _, t in made} == {
            datetime.timedelta(seconds=distributed.TIMEOUT_S)}
        assert {r: g for r, g in groups.items() if len(r) < 4} == {
            (0, 1): (0, 1), (1, 3): (1, 3)}

    def test_one_process_reduces_nothing_across(self):
        """A mesh of one process spans none: it is its own local mesh,
        holds every row, and its data-axis sum is the local one."""
        mesh = tmesh.build_mesh(MeshConfig(data=2, tensor=1), [CPU] * 2)
        assert not mesh.spans_processes and mesh.local() is mesh
        assert tmesh.process_rows(mesh, 6) == slice(0, 6)
        got = collectives.all_reduce_sum([torch.ones(2), torch.ones(2)])
        assert torch.equal(got[0], torch.full((2,), 2.0))


class TestCollectives:
    def test_grads_go_in_float32_buckets(self, monkeypatch):
        """`all_reduce_grads` reads the grads in order as one stream of
        float32 elements through buckets of GRAD_BUCKET elements (a grad
        may span buckets), reduces each bucket once and writes each grad
        back in its own dtype, a non-contiguous grad too; a tensor
        without a grad is left out; the next call reuses the bucket's
        buffer. The group is a stand-in that doubles what it is given,
        as two processes holding the same grads would."""
        seen = []

        def all_reduce(t):
            seen.append((t.dtype, t.numel(), t.untyped_storage().data_ptr()))
            t.mul_(2)

        monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
        monkeypatch.setattr(collectives, "GRAD_BUCKET", 6)
        shapes = [(2,), (3,), (7,), (1,), (2, 2), (5,)]
        tensors = [torch.zeros(s, dtype=torch.bfloat16 if i == 3
                               else torch.float32, requires_grad=True)
                   for i, s in enumerate(shapes)]
        grads = [torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape) + 1
                 for t in tensors]
        for t, g in zip(tensors, grads):
            t.grad = g.clone()
        tensors[4].grad = grads[4].t().contiguous().t()
        assert not tensors[4].grad.is_contiguous()
        tensors[5].grad = None
        collectives.all_reduce_grads(tensors)
        assert [x[:2] for x in seen] == [(torch.float32, 6)] * 2 + [
            (torch.float32, 5)]
        for t, g in zip(tensors[:5], grads):
            assert t.grad.dtype == t.dtype
            assert torch.equal(t.grad, 2 * g)
        assert tensors[5].grad is None
        collectives.all_reduce_grads(tensors[:1])
        assert seen[-1][:2] == (torch.float32, 2)
        assert len({x[2] for x in seen}) == 1

    def test_process_sum_keeps_dtype_and_device(self, monkeypatch):
        monkeypatch.setattr(torch.distributed, "all_reduce",
                            lambda t: t.mul_(3))
        x = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
        got = collectives.process_sum(x)
        assert got.dtype == torch.bfloat16 and torch.equal(got, 3 * x)
        assert torch.equal(x, torch.tensor([1.5, -2.0],
                                           dtype=torch.bfloat16))


# -- two processes against the JAX package -------------------------------------


STEPS = 3
BATCH, SEQ = 4, 17


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """JAX's three sharded steps at data=4 on jax.devices()[:4] and the
    port's over two processes of 2 CPU coordinates each, from one JAX
    state and the same batches."""
    tmp = tmp_path_factory.mktemp("dist")
    jcfg = jl.CONFIGS["tiny-llama"]
    jstate = jtrain.init_train_state(jax.random.PRNGKey(4), jcfg)
    np.savez(tmp / "init.npz", **_flat(jax.tree.map(np.asarray,
                                                    jstate.params)))
    batches = np.stack([
        np.random.default_rng(30 + s).integers(
            0, jcfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
        for s in range(STEPS)])
    np.save(tmp / "batches.npy", batches)

    mesh = jmesh.build_mesh(JMesh(data=4, tensor=1), jax.devices()[:4])
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(
            mesh, jmesh.compatible_spec(s, np.shape(x), mesh))),
        jstate.params, jl.param_specs(jcfg))
    step, _ = jtrain.make_sharded_train_step(jcfg, mesh)
    jstate = jtrain.TrainState(params, jax.device_put(jstate.opt_state),
                               jstate.step)
    jlosses = []
    for b in batches:
        with mesh:
            jstate, loss = step(jstate, jnp.asarray(b))
        jlosses.append(float(loss))
    want = _flat(jax.tree.map(np.asarray, jstate.params))

    spec = dict(model="tiny-llama", device="cpu", coords=2,
                init=str(tmp / "init.npz"), batches=str(tmp / "batches.npy"),
                out=str(tmp / "out"))
    env = {**os.environ, "GGRMCP_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "GGRMCP_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, json.dumps(spec)],
        env={**env, "GGRMCP_PROCESS_ID": str(pid)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{out[-3000:]}"
    got = []
    for rank in (0, 1):
        with np.load(tmp / f"out{rank}.npz") as f:
            got.append({k: f[k] for k in f.files})
    return dict(jlosses=jlosses, want=want, got=got)


def test_cross_process_sum_is_exact(two_processes):
    for got in two_processes["got"]:
        assert float(got["total"]) == 6.0  # 0 + 1 + 2 + 3


def test_global_mesh_spans_both_processes(two_processes):
    for rank, got in enumerate(two_processes["got"]):
        seen = json.loads(str(got["seen"]))
        assert (seen["rank"], seen["world"]) == (rank, 2)
        assert seen["backend"] == "gloo"
        assert seen["owners"] == [0, 0, 1, 1]
        assert seen["sizes"][0] == 4 and seen["local_sizes"][0] == 2
        assert seen["local_devices"] == ["cpu"]


def test_losses_match_jax(two_processes):
    for got in two_processes["got"]:
        np.testing.assert_allclose(got["losses"], two_processes["jlosses"],
                                   rtol=1e-4)


def test_params_match_jax(two_processes):
    got = two_processes["got"][0]
    for name, w in two_processes["want"].items():
        w = np.asarray(w, np.float64)
        diff = np.abs(np.asarray(got[f"p.{name}"], np.float64) - w)
        off = int((diff > 1e-4 * np.abs(w).max()).sum())
        assert off <= diff.size * 1e-4, f"{name}: {off} entries off"
        assert diff.max() <= 3 * LR, f"{name}: {diff.max()}"


def test_processes_keep_one_replica(two_processes):
    a, b = two_processes["got"]
    names = [k for k in a if k.startswith("p.")]
    assert names and all(np.array_equal(a[k], b[k]) for k in names)
    np.testing.assert_array_equal(a["losses"], b["losses"])
