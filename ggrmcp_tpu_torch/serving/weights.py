"""HuggingFace Llama / Mistral checkpoints into the port's parameters.

Port of `ggrmcp_tpu/serving/weights.py::{read_hf_config,
load_hf_checkpoint, load_hf_checkpoint_sharded}`. A checkpoint
directory holds `config.json` and `*.safetensors` files (sharded ones
listed by `model.safetensors.index.json`), read by `safetensors_io`.

Conversion, as in the reference:
- a torch Linear stores [out, in]; the port's matmuls are x @ W with W
  [in, out], so every projection is transposed;
- per-layer tensors are stacked along a leading layer axis, and wqkv is
  q, k and v concatenated along the output axis;
- RoPE is the rotate-half convention of HF, so Q/K rows need no
  permutation;
- a checkpoint without `lm_head.weight` ties it to the embedding.

Every tensor goes from the mapped file straight to the device in its
stored dtype, and is cast and transposed there into parameters
allocated up front, one tensor at a time: host memory holds about one
tensor, never a second copy of the model. The values equal the
reference's, which widens every tensor to float32 on the host and then
rounds to the model dtype (round to nearest even, as `Tensor.to` does).

`load_hf_checkpoint_sharded` places a checkpoint on a mesh: each
shard's window of each tensor is read from the file(s) straight into
that shard's tensor, the whole tensor never built on the host.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

import torch

from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models.llama import LlamaConfig
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving.safetensors_io import Checkpoint
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.weights")

# The last sharded load's wall time, bytes read and host RSS (the
# reference's module-level export of the same name).
last_load_stats: dict = {}


def _rss_mb() -> float:
    """Peak resident set size of this process in MB (ru_maxrss is KB on
    Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def read_hf_config(path: str) -> LlamaConfig:
    """Derive a LlamaConfig from a HF `config.json` directory."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if "Llama" not in arch and "Mistral" not in arch:
        raise ValueError(f"unsupported HF architecture: {arch}")
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
    rs = hf.get("rope_scaling") or None
    rope_scaling = None
    if rs:
        # Llama-3.1+ ships rope_type "llama3"; unscaled frequencies would
        # give silently divergent logits, so other schemes are an error.
        rope_type = rs.get("rope_type") or rs.get("type")
        if rope_type != "llama3":
            raise ValueError(
                f"unsupported rope_scaling type {rope_type!r} "
                f"(supported: 'llama3')"
            )
        rope_scaling = (
            float(rs["factor"]),
            float(rs.get("low_freq_factor", 1.0)),
            float(rs.get("high_freq_factor", 4.0)),
            float(rs["original_max_position_embeddings"]),
        )
    return LlamaConfig(
        name=hf.get("_name_or_path") or os.path.basename(path.rstrip("/"))
        or "hf-llama",
        vocab_size=hf["vocab_size"],
        hidden_dim=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        ffn_dim=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        # Mistral-style sliding window; HF uses null for full attention.
        sliding_window=hf.get("sliding_window") or None,
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        dtype="bfloat16",
    )


def load_hf_checkpoint(
    path: str, device: DeviceLike = None
) -> tuple[LlamaConfig, dict]:
    """HF checkpoint directory → (LlamaConfig, params on `device`), the
    layout of `llama.init_params`. Raises on a missing tensor or one
    whose shape does not fit the config."""
    cfg = read_hf_config(path)
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    n, d, f = cfg.num_layers, cfg.hidden_dim, cfg.ffn_dim
    hd, vocab = cfg.head_dim, cfg.vocab_size
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def empty(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=dev)

    layers = {
        "attn_norm": empty(n, d),
        "wqkv": empty(n, d, q_out + 2 * kv_out),
        "wo": empty(n, q_out, d),
        "mlp_norm": empty(n, d),
        "w_gate": empty(n, d, f),
        "w_up": empty(n, d, f),
        "w_down": empty(n, f, d),
    }
    params = {"embed": empty(vocab, d), "layers": layers,
              "final_norm": empty(d), "lm_head": empty(d, vocab)}

    with Checkpoint(path) as ckpt:
        def put(dst: torch.Tensor, name: str, transpose: bool = True):
            src = ckpt.read(name, dev)
            src = src.T if transpose else src
            if src.shape != dst.shape:
                raise ValueError(
                    f"{path}: {name} has shape {tuple(src.shape)}, the "
                    f"config needs {tuple(dst.shape)}"
                    + (" transposed" if transpose else "")
                )
            dst.copy_(src)

        put(params["embed"], "model.embed_tokens.weight", transpose=False)
        for i in range(n):
            pre = f"model.layers.{i}."
            put(layers["attn_norm"][i], pre + "input_layernorm.weight",
                transpose=False)
            qkv = layers["wqkv"][i]
            put(qkv[:, :q_out], pre + "self_attn.q_proj.weight")
            put(qkv[:, q_out:q_out + kv_out], pre + "self_attn.k_proj.weight")
            put(qkv[:, q_out + kv_out:], pre + "self_attn.v_proj.weight")
            put(layers["wo"][i], pre + "self_attn.o_proj.weight")
            put(layers["mlp_norm"][i], pre + "post_attention_layernorm.weight",
                transpose=False)
            put(layers["w_gate"][i], pre + "mlp.gate_proj.weight")
            put(layers["w_up"][i], pre + "mlp.up_proj.weight")
            put(layers["w_down"][i], pre + "mlp.down_proj.weight")
        put(params["final_norm"], "model.norm.weight", transpose=False)
        if "lm_head.weight" in ckpt.names:
            put(params["lm_head"], "lm_head.weight")
        else:  # tied embeddings
            params["lm_head"].copy_(params["embed"].T)
    logger.info(
        "loaded HF checkpoint %s: %s (%d layers, %d heads/%d kv, d=%d) "
        "on %s", path, cfg.name, n, cfg.num_heads, cfg.num_kv_heads, d, dev,
    )
    return cfg, params


def load_hf_checkpoint_sharded(
    path: str,
    mesh: mesh_mod.Mesh,
    on_downgrade: Optional[Callable] = None,
) -> tuple[LlamaConfig, dict]:
    """HF checkpoint directory → (LlamaConfig, params placed on `mesh`
    by `llama.param_specs`), shard by shard: for every parameter, each
    coordinate's window is read from the safetensors file(s) into its
    tensor on its device (a row range in one mapping, a column range
    row block by row block) and cast there, so the host holds about one
    block, never a whole tensor. The fused wqkv is stitched per head
    segment (q, k and v rows of the shard's heads, `llama.qkv_columns`).
    The values are those of `load_hf_checkpoint` split by the specs, bit
    for bit. A spec that does not divide its dim is reported to
    `on_downgrade(where, dim, entry, size, axis)` (the reference's
    count) and the leaf read whole; so is every leaf of its block
    (`llama.whole_blocks`), once per device. A one-coordinate mesh
    loads whole. `last_load_stats` records the wall time, the bytes
    read and the host RSS before and at peak."""
    global last_load_stats  # noqa: PLW0603 (the reference's export)
    t0 = time.monotonic()
    rss0 = _rss_mb()
    if mesh.size == 1:
        return load_hf_checkpoint(path, mesh.devices[0])
    cfg = read_hf_config(path)
    dtype = cfg.torch_dtype
    n, d, f = cfg.num_layers, cfg.hidden_dim, cfg.ffn_dim
    h, kvh, hd, vocab = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.vocab_size)
    specs = llama_mod.param_specs(cfg)
    shapes = llama_mod.param_shapes(cfg)
    whole = llama_mod.whole_leaves(cfg, mesh.shape["tensor"])
    bytes_read = 0

    with Checkpoint(path) as ckpt:
        def check(name: str, want: tuple):
            if ckpt.shape(name) != want:
                raise ValueError(
                    f"{path}: {name} has shape {ckpt.shape(name)}, the "
                    f"config needs {want}"
                )

        def window(dst, name: str, rows: slice, cols: slice,
                   transpose: bool):
            """dst [rows, cols] of the TARGET layout; a transposed
            tensor (a torch Linear [out, in]) reads the swapped window."""
            nonlocal bytes_read
            if transpose:
                bytes_read += ckpt.read_window(name, cols, rows, dst.T)
            else:
                bytes_read += ckpt.read_window(name, rows, cols, dst)

        def layer_src(key: str):
            """(checkpoint name of layer i, transposed) of a stacked leaf."""
            names = {
                "attn_norm": ("input_layernorm.weight", False),
                "wo": ("self_attn.o_proj.weight", True),
                "mlp_norm": ("post_attention_layernorm.weight", False),
                "w_gate": ("mlp.gate_proj.weight", True),
                "w_up": ("mlp.up_proj.weight", True),
                "w_down": ("mlp.down_proj.weight", True),
            }
            leaf, tr = names[key]
            return lambda i: (f"model.layers.{i}.{leaf}", tr)

        def fill_qkv(dst, i: int, block: int, n_blocks: int):
            """dst [D, cols] of layer i: the shard's q, k and v heads."""
            pre = f"model.layers.{i}.self_attn."
            cols = llama_mod.qkv_columns(cfg, n_blocks, block)
            at = 0
            for seg, base, width in (("q_proj", 0, h * hd),
                                     ("k_proj", h * hd, kvh * hd),
                                     ("v_proj", (h + kvh) * hd, kvh * hd)):
                mine = cols[(cols >= base) & (cols < base + width)] - base
                lo, hi = int(mine[0]), int(mine[-1]) + 1
                window(dst[:, at:at + hi - lo], pre + seg + ".weight",
                       slice(None), slice(lo, hi), transpose=True)
                at += hi - lo

        def place(key: str, where: str, spec, shape):
            adapted = llama_mod.placed_spec(
                spec, shape, mesh, key in whole, None if on_downgrade is None
                else lambda *a: on_downgrade(where, *a))
            stacked = key in ("attn_norm", "wqkv", "wo", "mlp_norm",
                              "w_gate", "w_up", "w_down")
            parts, seen = [], {}
            for c, dev in enumerate(mesh.devices):
                coord = mesh.coord(c)
                blocks = tuple(
                    (mesh_mod.block_index(mesh, e, coord),
                     mesh_mod.axis_product(mesh, e)) for e in adapted)
                if (blocks, dev) not in seen:
                    seen[(blocks, dev)] = read_block(key, shape, blocks, dev,
                                                     stacked)
                parts.append(seen[(blocks, dev)])
            return Sharded(tuple(parts), tuple(
                mesh_mod.axis_product(mesh, e) for e in adapted), mesh,
                torch.Size(shape) if key == "wqkv" else None,
                spec=tuple(adapted))

        def rng(size: int, block: int, n_blocks: int) -> slice:
            step = size // n_blocks
            return slice(block * step, (block + 1) * step)

        def read_block(key, shape, blocks, dev, stacked):
            local = [size // nb for size, (_, nb) in zip(shape, blocks)]
            if key == "wqkv":
                local[2] = len(llama_mod.qkv_columns(cfg, blocks[2][1],
                                                     blocks[2][0]))
            out = torch.empty(local, dtype=dtype, device=dev)
            if not stacked:
                name, tr, two_d = {
                    "embed": ("model.embed_tokens.weight", False, True),
                    "final_norm": ("model.norm.weight", False, False),
                    "lm_head": (lm_head_name, lm_head_tr, True),
                }[key]
                if not two_d:
                    dst = out[None]
                    window(dst, name, slice(None), slice(None), False)
                    return out
                rows = rng(shape[0], *blocks[0])
                cols = rng(shape[1], *blocks[1])
                window(out, name, rows, cols, tr)
                return out
            for i in range(n):
                if key == "wqkv":
                    fill_qkv(out[i], i, *blocks[2])
                    continue
                name, tr = layer_src(key)(i)
                if len(shape) == 2:  # a norm [L, D]
                    window(out[i][None], name, slice(None), slice(None),
                           False)
                    continue
                rows = rng(shape[1], *blocks[1])
                cols = rng(shape[2], *blocks[2])
                window(out[i], name, rows, cols, tr)
            return out

        # Shape checks before any read: the checkpoint must fit the config.
        check("model.embed_tokens.weight", (vocab, d))
        check("model.norm.weight", (d,))
        for i in range(n):
            pre = f"model.layers.{i}."
            check(pre + "self_attn.q_proj.weight", (h * hd, d))
            check(pre + "self_attn.k_proj.weight", (kvh * hd, d))
            check(pre + "self_attn.v_proj.weight", (kvh * hd, d))
            check(pre + "self_attn.o_proj.weight", (d, h * hd))
            check(pre + "mlp.gate_proj.weight", (f, d))
            check(pre + "mlp.up_proj.weight", (f, d))
            check(pre + "mlp.down_proj.weight", (d, f))
            check(pre + "input_layernorm.weight", (d,))
            check(pre + "post_attention_layernorm.weight", (d,))
        if "lm_head.weight" in ckpt.names:
            check("lm_head.weight", (vocab, d))
            lm_head_name, lm_head_tr = "lm_head.weight", True
        else:  # tied embeddings: lm_head[:, v] = embed[v, :]
            lm_head_name, lm_head_tr = "model.embed_tokens.weight", True

        params: dict = {"layers": {}}
        for key, spec in specs.items():
            if isinstance(spec, dict):
                for name, sub in spec.items():
                    params["layers"][name] = place(
                        name, f"['layers']['{name}']", sub,
                        shapes["layers"][name])
            else:
                params[key] = place(key, f"['{key}']", spec, shapes[key])
    last_load_stats = {
        "weight_load_s": round(time.monotonic() - t0, 2),
        "weight_load_bytes_read": bytes_read,
        "weight_load_rss_before_mb": round(rss0, 1),
        "weight_load_peak_host_rss_mb": round(_rss_mb(), 1),
        "weight_load_sharded": True,
    }
    logger.info(
        "sharded-loaded HF checkpoint %s onto %s: %s (%.1f MB read, "
        "%.1fs, host RSS peak %.0f → %.0f MB)", path,
        mesh_mod.mesh_shape_str(mesh), cfg.name, bytes_read / 1e6,
        last_load_stats["weight_load_s"], rss0,
        last_load_stats["weight_load_peak_host_rss_mb"],
    )
    return cfg, params
