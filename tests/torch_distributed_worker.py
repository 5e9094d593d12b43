"""One process of the port's two-process runtime tests
(tests/test_torch_distributed.py on the CPU, tests/test_torch_gpu.py on
the card). Imports only torch and the port.

    python tests/torch_distributed_worker.py SPEC_JSON

GGRMCP_COORDINATOR / GGRMCP_NUM_PROCESSES / GGRMCP_PROCESS_ID come from
the parent, the contract every process of a deployment uses. SPEC: the
model, the device, how many coordinates this process holds, the initial
params (an .npz of "layers.wqkv"-style leaves, or a seed for the
family's init), the batches (.npy [steps, B, S]) and the output prefix.
The process joins the group (`distributed.initialize`), builds the
global mesh, sums a range over the data axis across processes, takes
the AdamW steps over the global mesh, and writes `<out><rank>.npz`: the
sum, each step's loss, the final params and a JSON line of what it saw
(mesh, backend, B1 launches). Any failure exits non-zero.

SPEC may instead be {"device": ..., "runs": [RUN, ...]}: one process
group takes every run in turn (tests/test_torch_process_axes.py, over
two processes and over four). A RUN
names its model ("tiny-llama" or "tiny-moe"), its mesh axes (the
coordinates split evenly over the processes; a stage axis trains
through the pipeline's step), the initial params and batches as above,
its output prefix, and optionally a planted fault ("tensor_backward":
the gradient sum of `collectives.copy_in` skipped; "stage_reduce": the
gradient reduces across processes of `training.train_step` skipped,
at data=1 the stage group's sum of the leaves the stages replicate) or
"exit_before_step": RANK (that process exits with code 5 before its
first step; the other's first collective must raise). Each run
writes `<out><rank>.npz`: the losses, the whole final params, this
process's stored parts keyed by leaf and block, the groups it formed,
and for the MoE family each step's router aux loss and dropped pairs as
this process routed them.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    import numpy as np
    import torch

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama, trainer, training
    from ggrmcp_tpu_torch.models.convert import params_from_numpy
    from ggrmcp_tpu_torch.ops import attention
    from ggrmcp_tpu_torch.parallel import collectives, distributed
    from ggrmcp_tpu_torch.serving.checkpoint import unflatten

    spec = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    if "runs" in spec:
        return runs(spec)
    assert distributed.initialize(device=spec["device"]), "no process group"
    rank = torch.distributed.get_rank()
    dev = distributed.local_device()
    mesh = distributed.global_mesh(MeshConfig(data=0, tensor=1),
                                   [dev] * spec["coords"])
    local = mesh.local()

    # A range over the data axis, each coordinate holding its entry.
    x = torch.arange(float(mesh.size))
    parts = [x[i].to(mesh.devices[i]) for i in mesh.local_indices()]
    total = collectives.process_sum(
        collectives.all_reduce_sum(parts)[0]).item()

    cfg = llama.CONFIGS[spec["model"]]
    if spec.get("init"):
        with np.load(spec["init"]) as init:
            params = params_from_numpy(unflatten(dict(init)), dev)
    else:
        params = llama.init_params(cfg, dev, spec["seed"])
    state = training.make_train_state(params, cfg, mesh=mesh)
    batches = np.load(spec["batches"])
    attention.flash_attention.launches = 0
    losses = []
    for batch in batches:
        state, loss = training.train_step(
            state, torch.from_numpy(batch).to(dev), cfg)
        losses.append(loss.item())
    final = {f"p.{k}": v.detach().float().cpu().numpy()
             for k, v in trainer.state_tensors(state, cfg)[0].items()}
    seen = dict(
        rank=rank, world=torch.distributed.get_world_size(),
        backend=torch.distributed.get_backend(), sizes=list(mesh.sizes),
        owners=list(mesh.owners), local_sizes=list(local.sizes),
        local_devices=[str(d) for d in mesh.distinct_devices()],
        launches=attention.flash_attention.launches)
    np.savez(f"{spec['out']}{rank}.npz", total=np.float64(total),
             losses=np.asarray(losses, np.float64),
             seen=np.asarray(json.dumps(seen)), **final)
    torch.distributed.destroy_process_group()
    print(f"OK process={rank} {json.dumps(seen)}", flush=True)


def runs(spec: dict) -> None:
    """Every run of SPEC["runs"] over one process group."""
    import math

    import numpy as np
    import torch

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama, moe, trainer, training
    from ggrmcp_tpu_torch.models.convert import params_from_numpy
    from ggrmcp_tpu_torch.parallel import collectives, distributed, pipeline
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.checkpoint import unflatten

    assert distributed.initialize(device=spec["device"]), "no process group"
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    dev = distributed.local_device()
    for run in spec["runs"]:
        axes = {"data": 1, "tensor": 1, **run["axes"]}
        mesh = distributed.global_mesh(
            MeshConfig(**axes), [dev] * (math.prod(axes.values()) // world))
        fam = moe if run["model"] in moe.CONFIGS else llama
        cfg = fam.CONFIGS[run["model"]]
        with np.load(run["init"]) as init:
            params = params_from_numpy(unflatten(dict(init)), dev)
        state = training.make_train_state(params, cfg, mesh=mesh)
        if run.get("exit_before_step") == rank:
            os._exit(5)
        step = (pipeline.make_pipeline_train_step(cfg, mesh)
                if axes.get("stage", 1) > 1 else
                lambda st, tok: training.train_step(st, tok, cfg))
        routed: dict = {"aux": [], "dropped": []}
        assign, aux_loss = moe._assign, moe._aux_loss

        def spy_assign(*args, **kwargs):
            out = assign(*args, **kwargs)
            routed["dropped"][-1] += int((~out[-1]).sum())
            return out

        def spy_aux(*args, **kwargs):
            out = aux_loss(*args, **kwargs)
            routed["aux"][-1].append(out.item())
            return out

        moe._assign, moe._aux_loss = spy_assign, spy_aux
        copy_back = collectives._CopyIn.backward
        reduce_back = training.all_reduce_grads
        if run.get("fault") == "tensor_backward":
            collectives._CopyIn.backward = staticmethod(
                lambda ctx, grad: (grad, None))
        if run.get("fault") == "stage_reduce":
            training.all_reduce_grads = lambda tensors, group=None: None
        losses = []
        try:
            for batch in np.load(run["batches"]):
                routed["aux"].append([])
                routed["dropped"].append(0)
                state, loss = step(state, torch.from_numpy(batch).to(dev))
                losses.append(loss.item())
        finally:
            moe._assign, moe._aux_loss = assign, aux_loss
            collectives._CopyIn.backward = copy_back
            training.all_reduce_grads = reduce_back
        whole = {f"p.{k}": v.detach().float().cpu().numpy()
                 for k, v in trainer.state_tensors(state, cfg)[0].items()}
        held = {}
        for name, leaf in training.named_leaves(state.params):
            for i, part in enumerate(leaf.parts):
                if part is not None:
                    key = "-".join(
                        str(mesh_mod.block_index(mesh, e, mesh.coord(i)))
                        for e in leaf.spec)
                    held[f"h.{name}.{key}"] = (
                        part.detach().float().cpu().numpy())
        seen = dict(rank=rank, sizes=list(mesh.sizes),
                    owners=list(mesh.owners),
                    local_sizes=list(mesh.local().sizes),
                    groups=sorted(list(r) for r in mesh.groups))
        np.savez(f"{run['out']}{rank}.npz",
                 losses=np.asarray(losses, np.float64),
                 aux=np.asarray([np.mean(a) if a else np.nan
                                 for a in routed["aux"]], np.float64),
                 dropped=np.asarray(routed["dropped"], np.int64),
                 seen=np.asarray(json.dumps(seen)), **whole, **held)
        del state
        print(f"OK run={run['out']} process={rank}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
