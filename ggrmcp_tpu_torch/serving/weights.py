"""HuggingFace Llama / Mistral checkpoints into the port's parameters.

Port of `ggrmcp_tpu/serving/weights.py::{read_hf_config,
load_hf_checkpoint}`. A checkpoint directory holds `config.json` and
`*.safetensors` files (sharded ones listed by
`model.safetensors.index.json`), read by `safetensors_io`.

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
"""

from __future__ import annotations

import json
import logging
import os

import torch

from ggrmcp_tpu_torch.models.llama import LlamaConfig
from ggrmcp_tpu_torch.serving.safetensors_io import Checkpoint
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.weights")


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
