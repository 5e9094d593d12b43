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


if __name__ == "__main__":
    main()
