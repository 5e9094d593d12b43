"""A configuration file's model: its shape, and its weights drawn from the
seed on the device.

The weights are the benchmark's, made in a few large draws from one
`torch.Generator` on the device, in bf16 (the router in float32), in the
port's layout: stacked [L, ...] leaves, wqkv's columns the query heads,
then the key heads, then the value heads, each head's Dh contiguous.
The same seed gives the same weights, so the reference draws them again
after the program is gone rather than reading anything the program held.
Plain `torch` only: the reference uses this module too.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

FAMILIES = ("llama", "moe")


def load(path: Path) -> dict:
    with open(path) as fh:
        cfg = json.load(fh)
    if cfg["family"] not in FAMILIES:
        raise ValueError(f"{path}: family must be one of {FAMILIES}")
    return cfg


def shape(cfg: dict) -> dict:
    """The sizes the benchmark computes with, from the published keys."""
    heads = cfg["num_attention_heads"]
    m = dict(
        family=cfg["family"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=heads,
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        ffn=cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        window=cfg.get("sliding_window"),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        dtype=cfg.get("torch_dtype", "bfloat16"),
    )
    if cfg["family"] == "moe":
        m.update(experts=cfg["num_local_experts"],
                 experts_per_token=cfg["num_experts_per_tok"])
    return m


def leaf_shapes(m: dict) -> dict:
    """Every leaf of the tree, in draw order: name -> (shape, std)."""
    d, n, hd = m["hidden"], m["layers"], m["head_dim"]
    h, kvh, f, v = m["heads"], m["kv_heads"], m["ffn"], m["vocab"]
    bank = (n, m["experts"]) if m["family"] == "moe" else (n,)
    out = {
        "embed": ((v, d), 0.02),
        "attn_norm": ((n, d), None),
        "wqkv": ((n, d, (h + 2 * kvh) * hd), d ** -0.5),
        "wo": ((n, h * hd, d), (h * hd) ** -0.5),
        "mlp_norm": ((n, d), None),
    }
    if m["family"] == "moe":
        out["router"] = ((n, d, m["experts"]), d ** -0.5)
    out.update({
        "w_gate": ((*bank, d, f), d ** -0.5),
        "w_up": ((*bank, d, f), d ** -0.5),
        "w_down": ((*bank, f, d), f ** -0.5),
        "final_norm": ((d,), None),
        "lm_head": ((d, v), d ** -0.5),
    })
    return out


def make_weights(m: dict, seed: int, device) -> dict:
    """The seed's weights on `device`, in the configuration's dtype, as
    the port's parameter tree.
    Norm weights are 1 + N(0, 0.1²), so that the norms' scales count;
    every other leaf is N(0, std²) at the port's init scales."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    leaves = {}
    for name, (shp, std) in leaf_shapes(m).items():
        dtype = (torch.float32 if name == "router"
                 else getattr(torch, m["dtype"]))
        t = torch.empty(shp, dtype=dtype, device=device)
        if std is None:
            t.normal_(1.0, 0.1, generator=gen)
        else:
            t.normal_(0.0, std, generator=gen)
        leaves[name] = t
    top = ("embed", "final_norm", "lm_head")
    tree = {k: leaves.pop(k) for k in top}
    tree["layers"] = leaves
    return tree
