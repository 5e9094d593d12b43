"""The training step: LM loss, gradients, AdamW. Port of
`ggrmcp_tpu/models/training.py`.

- `lm_loss` is next-token cross entropy over [B, S] tokens (inputs
  `tokens[:, :-1]`, targets `tokens[:, 1:]`), through the family's
  forward without a cache; a sparse-MoE config adds `router_aux_weight`
  times the mean router load-balance loss (`moe.forward_with_aux`).
  Attention takes the dispatcher's path, so on the card every query
  longer than 8 runs the FlashAttention kernel forward, and its gradient
  is the plain version's (ops/attention.py `FlashAttentionFn`). The
  reference trains through XLA's attention at its default length; the
  function computed is the same.
- The optimizer is `torch.optim.AdamW` with optax `adamw`'s constants
  (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decay on every leaf): the
  same update up to rounding.
- Params stay the port's dict of stacked [L, ...] leaves, each stored
  tensor a leaf of autograd (`requires_grad`); nothing on the loss path
  writes one in place. On a mesh (`TrainState.specs`) the leaves are
  `Sharded`, the optimizer steps every stored part, and before it does,
  parts that hold the same parameters (a replica of a block, the
  replicated KV columns of the fused wqkv) get the sum of their
  gradients (`collectives.sum_tied_grads`), so replicas never drift
  apart. A `stage` axis above 1 trains through parallel/pipeline.py.
- With data blocks (`data` x `fsdp` above 1) the [B, S] batch splits
  over them (`mesh.data_blocks`): each block's rows run on its own
  coordinates, whose weights are the replicated leaves (on one device
  one stored tensor, which accumulates every block's gradient; on
  several, parts `sum_tied_grads` adds up). The blocks' logits come
  back in batch order and the loss is ONE mean over the global batch's
  tokens (a MoE aux term over the global batch's routing), so the
  blocks' gradients sum to the unsharded gradient. `fsdp` shards the
  batch as `data` does: the reference's specs shard no weight over it.
- `TrainState` is mutable: `train_step` advances it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.models import family_module
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models import moe as moe_mod
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import Sharded, sum_tied_grads

Params = common.Params


@dataclasses.dataclass
class TrainState:
    """Params, their optimizer and the count of steps taken. `specs`:
    the spec tree the params were sharded by (None on one device)."""

    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0
    specs: Optional[Params] = None


def next_token_xent(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy: logits [B, S, V], targets [B, S];
    `log_softmax` in float32, then the targets' entries. The one loss of
    the plain and the pipelined trainers."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    picked = logprobs.gather(-1, targets.long().to(logits.device)[..., None])
    return -picked[..., 0].mean()


def lm_loss(params: Params, cfg: llama_mod.LlamaConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over [B, S] with shift-by-one targets,
    plus the MoE router's weighted load-balance loss."""
    if isinstance(cfg, moe_mod.MoEConfig):
        logits, _, aux = moe_mod.forward_with_aux(params, cfg, tokens[:, :-1])
        return (next_token_xent(logits, tokens[:, 1:])
                + cfg.router_aux_weight * aux.to(logits.device))
    logits, _ = llama_mod.forward(params, cfg, tokens[:, :-1])
    return next_token_xent(logits, tokens[:, 1:])


def _parts(leaf) -> list[torch.Tensor]:
    return leaf.distinct() if isinstance(leaf, Sharded) else [leaf]


def named_leaves(tree: Params, prefix: str = ""):
    """(path, leaf) of every leaf, "layers.wqkv" style, in the tree's
    order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from named_leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def stored_tensors(params: Params) -> list[torch.Tensor]:
    """Every stored tensor of the tree once, in the tree's order (a
    `Sharded` leaf gives its distinct parts)."""
    out: dict[int, torch.Tensor] = {}
    for _, leaf in named_leaves(params):
        for t in _parts(leaf):
            out.setdefault(id(t), t)
    return list(out.values())


def make_optimizer(params: Params, learning_rate: float = 3e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every stored tensor with optax `adamw`'s constants."""
    return torch.optim.AdamW(
        stored_tensors(params), lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay)


def mesh_specs(cfg: llama_mod.LlamaConfig,
               mesh: Optional[mesh_mod.Mesh]) -> Optional[Params]:
    """The specs a train state shards its params by on `mesh`: the
    family's, the layer dim over `stage` when the mesh pipelines; None
    on one coordinate."""
    if mesh is None or mesh.size == 1:
        return None
    if mesh_mod.axis_size(mesh, "stage") > 1:
        from ggrmcp_tpu_torch.parallel import pipeline

        return pipeline.param_specs_pp(cfg)
    return family_module(cfg).param_specs(cfg)


def make_train_state(
    params: Params,
    cfg: llama_mod.LlamaConfig,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
    mesh: Optional[mesh_mod.Mesh] = None,
    step: int = 0,
    moments: Optional[tuple[Params, Params]] = None,
) -> TrainState:
    """A train state over a whole tree: sharded IN PLACE onto `mesh`
    (when it has more than one coordinate), every stored tensor made a
    leaf that requires grad, AdamW built over them. `moments`: whole
    (exp_avg, exp_avg_sq) trees of the tree's shapes, with `step` the
    count of updates they hold (a resumed or carried state)."""
    specs = mesh_specs(cfg, mesh)
    if specs is not None:
        params = llama_mod.shard_params(params, cfg, mesh, specs)
    for t in stored_tensors(params):
        t.requires_grad_(True)
    optimizer = make_optimizer(params, learning_rate, weight_decay)
    if moments is not None:
        avg, avg_sq = (dict(named_leaves(
            llama_mod.shard_params(m, cfg, mesh, specs) if specs is not None
            else m)) for m in moments)
        for name, leaf in named_leaves(params):
            for p, a, sq in zip(_parts(leaf), _parts(avg[name]),
                                _parts(avg_sq[name])):
                if a.shape != p.shape or sq.shape != p.shape:
                    raise ValueError(
                        f"moments of {name}: {tuple(a.shape)} / "
                        f"{tuple(sq.shape)} for a part of {tuple(p.shape)}")
                optimizer.state[p] = {
                    "step": torch.tensor(float(step)),
                    "exp_avg": a.to(p.device, p.dtype),
                    "exp_avg_sq": sq.to(p.device, p.dtype),
                }
    return TrainState(params, optimizer, step, specs)


def init_train_state(
    cfg: llama_mod.LlamaConfig,
    device,
    seed: int = 0,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
    mesh: Optional[mesh_mod.Mesh] = None,
) -> TrainState:
    """A fresh state: the family's `init_params(cfg, device, seed)`."""
    params = family_module(cfg).init_params(cfg, torch.device(device), seed)
    return make_train_state(params, cfg, learning_rate, weight_decay, mesh)


def _tie_grads(params: Params, specs: Params,
               cfg: llama_mod.LlamaConfig) -> None:
    """Sum the gradients of every leaf's replicas (`sum_tied_grads`). A
    whole block's leaf is computed once per device, so each replica
    holds the gradient of its own device's uses, and the sum is the
    whole gradient, not a multiple of it."""
    for key, spec in specs.items():
        group = (params[key].items() if isinstance(spec, dict)
                 else [(key, params[key])])
        subs = spec if isinstance(spec, dict) else {key: spec}
        for name, leaf in group:
            if isinstance(leaf, Sharded):
                whole = llama_mod.whole_leaves(cfg,
                                               leaf.mesh.shape["tensor"])
                adapted = llama_mod.placed_spec(subs[name], leaf.shape,
                                                leaf.mesh, name in whole)
                sum_tied_grads(leaf, adapted,
                               llama_mod.shard_index_fn(cfg, name))


def train_step(
    state: TrainState,
    tokens: torch.Tensor,  # [B, S] on the params' (first) device
    cfg: llama_mod.LlamaConfig,
    loss_fn: Optional[Callable] = None,
) -> tuple[TrainState, torch.Tensor]:
    """One optimization step, in place: `loss_fn(params, cfg, tokens)`
    (default `lm_loss`), its gradients (tied across replicas on a mesh),
    one AdamW update. Returns (the state, the loss, detached)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = (loss_fn or lm_loss)(state.params, cfg, tokens)
    loss.backward()
    if state.specs is not None:
        _tie_grads(state.params, state.specs, cfg)
    state.optimizer.step()
    state.step += 1
    return state, loss.detach()
