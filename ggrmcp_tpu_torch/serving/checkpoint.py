"""The port's checkpoints: what the trainer saves, what a resumed run
loads and what `serving.checkpoint_path` / `speculative_draft_checkpoint`
serve.

The counterpart of `ggrmcp_tpu/serving/checkpoint.py`, in a format of
the port's own: the reference writes Orbax trees, and Orbax (a JAX
library) is absent from the machine with the card. The layout is the
reference trainer's:

    <dir>/step_N/params   the weights (what a sidecar serves)
    <dir>/step_N/state    the weights, AdamW's moments and the step
                          (what a resumed run loads)

Each directory holds `tensors.safetensors` (serving/safetensors_io.py;
leaves named by their path in the tree, "layers.wqkv", in their own
dtype, the moments as "exp_avg.<leaf>" and "exp_avg_sq.<leaf>") and
`meta.json`: {"format": FORMAT, "kind": "params" | "state", "model",
"step", "dtype"}. A directory is written under a temporary name and
renamed into place, so a crash never leaves a half-written step for
`latest_step` to resume from. An Orbax tree is refused, named as the
JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Optional

from ggrmcp_tpu_torch.serving import safetensors_io

logger = logging.getLogger("ggrmcp.torch.checkpoint")

FORMAT = "ggrmcp_tpu_torch.checkpoint/1"
META = "meta.json"
TENSORS = "tensors.safetensors"
MOMENTS = ("exp_avg", "exp_avg_sq")
# What an Orbax StandardCheckpointer directory holds (any one names it).
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of tensors → {"a.b": tensor}, in the tree's order."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, f"{name}."))
        else:
            out[name] = value
    return out


def unflatten(flat: dict) -> dict:
    """`flatten`'s inverse."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def save(path: str, tensors: dict, *, kind: str, model: str, step: int,
         dtype: str) -> None:
    """Write one checkpoint directory: `tensors` (a flat {name: tensor})
    and its meta.json, atomically (a temporary directory renamed over
    `path`)."""
    path = os.path.abspath(path)
    tmp = f"{path}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    nbytes = safetensors_io.write_file(os.path.join(tmp, TENSORS), tensors)
    meta = dict(format=FORMAT, kind=kind, model=model, step=int(step),
                dtype=dtype)
    with open(os.path.join(tmp, META), "w") as fh:
        json.dump(meta, fh)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    logger.info("saved %s checkpoint (%.1f MB) to %s", kind, nbytes / 1e6,
                path)


def read_meta(path: str, what: str = "checkpoint") -> dict:
    """meta.json of a checkpoint of the port's format at `path`; an
    absent directory, an Orbax tree or anything else raises ValueError
    naming `what` (the config field that pointed here)."""
    if not os.path.isdir(path):
        raise ValueError(f"{what} {path!r}: no such directory")
    names = set(os.listdir(path))
    meta_path = os.path.join(path, META)
    if META not in names and names & set(_ORBAX_MARKERS):
        raise ValueError(
            f"{what} {path!r} is an Orbax checkpoint of the JAX package "
            f"(ggrmcp_tpu); the PyTorch port reads its own format "
            f"({META} + {TENSORS}, format {FORMAT!r}), which `python -m "
            f"ggrmcp_tpu_torch train` writes")
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        meta = None
    if not isinstance(meta, dict) or meta.get("format") != FORMAT:
        raise ValueError(
            f"{what} {path!r} is not a checkpoint of the port's format (no "
            f"{META} with format {FORMAT!r})")
    return meta


def load(path: str, device, what: str = "checkpoint") -> tuple[dict, dict]:
    """(meta, {name: tensor on `device`}) of a checkpoint directory."""
    meta = read_meta(path, what)
    with safetensors_io.Checkpoint(path) as ck:
        flat = {name: ck.read(name, device) for name in ck.weight_map}
    return meta, flat


def load_params(path: str, device, model: Optional[str] = None,
                shapes: Optional[dict] = None,
                what: str = "checkpoint") -> dict:
    """The weights of a params (or state) checkpoint as the port's tree
    on `device`. `model`: the registry key the caller serves, which the
    checkpoint's must equal; `shapes`: the family's `param_shapes`, which
    every leaf must match, none missing and none extra."""
    meta, flat = load(path, device, what)
    if model is not None and meta.get("model") != model:
        raise ValueError(
            f"{what} {path!r} holds {meta.get('model')!r}, not {model!r}")
    params = {name: t for name, t in flat.items()
              if name.split(".")[0] not in MOMENTS}
    if shapes is not None:
        want = {name: tuple(s) for name, s in flatten(shapes).items()}
        got = {name: tuple(t.shape) for name, t in params.items()}
        if got != want:
            bad = sorted(n for n in set(got) | set(want)
                         if got.get(n) != want.get(n))
            raise ValueError(
                f"{what} {path!r}: leaves {bad} do not match {model!r} "
                f"(checkpoint {[got.get(n) for n in bad]}, model "
                f"{[want.get(n) for n in bad]})")
    logger.info("loaded %s step %s from %s", meta.get("model"),
                meta.get("step"), path)
    return unflatten(params)
