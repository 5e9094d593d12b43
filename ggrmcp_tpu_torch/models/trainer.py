"""The training loop with checkpoint and resume: `python -m
ggrmcp_tpu_torch train`. Port of `ggrmcp_tpu/models/trainer.py`.

The loop drives models/training.py's step on the device (CUDA unless
the caller asks for the CPU), on a mesh when `TrainingConfig.mesh` asks
for more than one coordinate (the batch over data x fsdp, tensor,
expert for MoE, stage through parallel/pipeline.py), and
persists through serving/checkpoint.py, in the port's own format:

    <checkpoint_dir>/step_N/state    params, AdamW moments, step (resume)
    <checkpoint_dir>/step_N/params   weights only: what a sidecar points
                                     serving.checkpoint_path at

Data is a raw text file (byte-tokenized, random windows of seq_len) or a
synthetic token stream, drawn exactly as the reference draws them
(`_data_stream`: numpy `default_rng([seed, start_step])`), so the two
packages train on the same batches.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ggrmcp_tpu_torch.core.config import TrainingConfig
from ggrmcp_tpu_torch.models import family_module, get_model
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models import training
from ggrmcp_tpu_torch.ops import attention as attn_ops
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import Sharded, unshard
from ggrmcp_tpu_torch.serving import checkpoint
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.models.trainer")


def _data_stream(
    cfg: TrainingConfig, vocab_size: int, start_step: int = 0
) -> Iterator[np.ndarray]:
    """Yields [batch, seq_len] int32 batches forever. `start_step` is
    folded into the rng seed so a resumed run does not re-train on the
    batches the pre-crash run already consumed."""
    rng = np.random.default_rng([cfg.seed, start_step])
    if cfg.data_path:
        from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer

        with open(cfg.data_path, "r", encoding="utf-8") as fh:
            ids = ByteTokenizer().encode(fh.read())
        if len(ids) < cfg.seq_len + 1:
            raise ValueError(
                f"data file too small: {len(ids)} tokens < seq_len+1"
            )
        tokens = np.asarray(ids, np.int32) % vocab_size
        while True:
            starts = rng.integers(
                0, len(tokens) - cfg.seq_len, size=cfg.batch_size
            )
            yield np.stack([tokens[s : s + cfg.seq_len] for s in starts])
    else:
        while True:
            yield rng.integers(
                0, vocab_size, size=(cfg.batch_size, cfg.seq_len),
                dtype=np.int32,
            )


def latest_step(checkpoint_dir: str) -> Optional[int]:
    """Highest N with a step_N/state checkpoint under the dir."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(checkpoint_dir)
        if (m := re.fullmatch(r"step_(\d+)", name))
        and os.path.isdir(os.path.join(checkpoint_dir, name, "state"))
    ]
    return max(steps) if steps else None


def train(cfg: TrainingConfig, device: DeviceLike = None
          ) -> training.TrainState:
    """Run the loop (on `device`: CUDA unless the CPU is asked for);
    returns the final TrainState."""
    family, model_cfg = get_model(cfg.model)
    if family == "bert":
        raise ValueError("training targets decoder models")
    # A `sequence` axis replicates, as the reference's trainer places
    # it: no param spec names it and the batch splits over data x fsdp
    # only (the port's sequence axis serves fresh prefills; there is no
    # ring or Ulysses in training). On one controller its replicas would
    # compute the same thing, so the step computes once, at sequence
    # index 0 (`llama.forward_tp`), and the replicas on other devices
    # take the summed gradient (`collectives.sum_tied_grads`).
    mesh = mesh_mod.serving_mesh(cfg.mesh, device)
    dev = resolve_device(mesh.devices[0])
    if mesh.shape["expert"] > 1 and family != "moe":
        raise ValueError(
            f"training.mesh.expert={mesh.shape['expert']} needs a MoE "
            f"model; {model_cfg.name} has no experts to shard")
    fam = family_module(model_cfg)

    start_step = 0
    resume_from = latest_step(cfg.checkpoint_dir) if cfg.resume else None
    if resume_from is not None:
        path = os.path.join(cfg.checkpoint_dir, f"step_{resume_from}",
                            "state")
        meta, flat = checkpoint.load(path, dev)
        if meta.get("model") != cfg.model:
            raise ValueError(
                f"{path} holds {meta.get('model')!r}, not {cfg.model!r}")
        trees = {prefix: checkpoint.unflatten({
            name[len(prefix) + 1:]: t for name, t in flat.items()
            if name.startswith(prefix + ".")}) for prefix in checkpoint.MOMENTS}
        params = checkpoint.unflatten({
            name: t for name, t in flat.items()
            if name.split(".")[0] not in checkpoint.MOMENTS})
        start_step = int(meta["step"])
        state = training.make_train_state(
            params, model_cfg, cfg.learning_rate, cfg.weight_decay, mesh,
            step=start_step,
            moments=(trees["exp_avg"], trees["exp_avg_sq"]))
        logger.info("resumed from step %d", start_step)
    else:
        params = fam.init_params(model_cfg, dev, cfg.seed)
        state = training.make_train_state(
            params, model_cfg, cfg.learning_rate, cfg.weight_decay, mesh)

    step_fn = _step_fn(model_cfg, mesh)
    data = _data_stream(cfg, model_cfg.vocab_size, start_step)
    launches = attn_ops.flash_attention.launches
    recomputes = attn_ops.flash_attention.backward_recomputes
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # ms/step: the wall time of the steps since the last log line, saves
    # excluded (the loss read waits for the device).
    t0 = t_last = time.monotonic()
    last = start_step
    for step in range(start_step, cfg.steps):
        batch = torch.from_numpy(next(data)).to(dev)
        state, loss = step_fn(state, batch)
        done = step + 1
        if done % cfg.log_every_steps == 0 or done == cfg.steps:
            loss_f = float(loss)
            now = time.monotonic()
            logger.info(
                "step %d/%d loss=%.4f (%.2f steps/s, %.1f ms/step)",
                done, cfg.steps, loss_f, (done - start_step) / (now - t0),
                (now - t_last) * 1e3 / (done - last),
            )
            t_last, last = now, done
            if not np.isfinite(loss_f):
                raise FloatingPointError(f"non-finite loss at step {done}")
        if cfg.checkpoint_dir and (
            done % cfg.save_every_steps == 0 or done == cfg.steps
        ):
            _save(cfg, model_cfg, done, state)
            t_last = time.monotonic()
    logger.info(
        "trained steps %d-%d: attention kernel launches %d, backward "
        "recomputes %d, peak device memory %.2f GB", start_step + 1,
        cfg.steps, attn_ops.flash_attention.launches - launches,
        attn_ops.flash_attention.backward_recomputes - recomputes,
        torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
        else 0.0)
    return state


def _step_fn(model_cfg, mesh: mesh_mod.Mesh):
    if mesh.shape["stage"] > 1:
        from ggrmcp_tpu_torch.parallel import pipeline

        return pipeline.make_pipeline_train_step(model_cfg, mesh)

    def step(state, tokens):
        return training.train_step(state, tokens, model_cfg)

    return step


def _whole(leaf, name: str, spec, cfg) -> torch.Tensor:
    """A leaf as one tensor (a `Sharded` one put back together by the
    adapted spec it was sharded by)."""
    if not isinstance(leaf, Sharded):
        return leaf.detach()
    adapted = mesh_mod.compatible_spec(spec, leaf.shape, leaf.mesh)
    index_fn = llama_mod.shard_index_fn(cfg, name.split(".")[-1])
    return unshard(leaf, adapted, index_fn).detach()


def state_tensors(state: training.TrainState, cfg) -> tuple[dict, dict]:
    """(params, the AdamW moments) of a state as flat {name: whole
    tensor} dicts, the moments named "exp_avg.<leaf>" /
    "exp_avg_sq.<leaf>" (zeros for a part never stepped)."""
    specs = dict(training.named_leaves(state.specs)) if state.specs else {}
    params, moments = {}, {}
    for name, leaf in training.named_leaves(state.params):
        spec = specs.get(name)
        params[name] = _whole(leaf, name, spec, cfg)
        parts = leaf.parts if isinstance(leaf, Sharded) else (leaf,)
        for m in checkpoint.MOMENTS:
            held = tuple(None if p is None else state.optimizer.state[p].get(
                m, torch.zeros_like(p)) for p in parts)
            moment = (Sharded(held, leaf.factors, leaf.mesh, leaf.full)
                      if isinstance(leaf, Sharded) else held[0])
            moments[f"{m}.{name}"] = _whole(moment, name, spec, cfg)
    return params, moments


def _save(cfg: TrainingConfig, model_cfg, step: int,
          state: training.TrainState) -> None:
    base = os.path.join(cfg.checkpoint_dir, f"step_{step}")
    params, moments = state_tensors(state, model_cfg)
    meta = dict(model=cfg.model, step=step, dtype=model_cfg.dtype)
    checkpoint.save(os.path.join(base, "params"), params, kind="params",
                    **meta)
    checkpoint.save(os.path.join(base, "state"), {**params, **moments},
                    kind="state", **meta)
    logger.info("checkpointed step %d to %s", step, base)
