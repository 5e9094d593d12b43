"""Multi-LoRA serving: per-request low-rank adapters on the fused qkv
projection, batched in one continuous batch. Port of
`ggrmcp_tpu/ops/lora.py`.

- The factors are stacked `[L, N+1, ...]` inside `params["layers"]`
  (keys `lora_qkv_a` / `lora_qkv_b`), so the layer loop slices them
  like every other stacked weight.
- Row 0 is the base "adapter": both factors zero, so a request without
  an adapter runs the same code with a zero delta. `b` starts at zero
  for every row: an adapter is a no-op until its trained factors are
  loaded.
- The delta of one layer is a per-row gather of each row's factors and
  two batched products, `[B, S, D] @ [B, D, r] @ [B, r, O]`: one batch
  serves any mix of adapters, with no loop over rows or adapters.

Factors are stored pre-scaled (alpha / r folded into `b`). The
reference draws `a` from `jax.random`, which torch cannot reproduce:
parity between the packages goes through factors carried over
(models/convert.py) or loaded from the same `.npz` files.
"""

from __future__ import annotations

import torch


def init_lora_layers(
    cfg, num_adapters: int, rank: int, generator: torch.Generator,
    device=None,
) -> dict:
    """{"lora_qkv_a": [L, N+1, D, r], "lora_qkv_b": [L, N+1, r,
    (H + 2 KVH) * Dh]} in the model dtype: `a` a small normal draw from
    `generator` with the base row 0 zeroed, `b` all zero."""
    l, d = cfg.num_layers, cfg.hidden_dim
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dtype = cfg.torch_dtype
    a = 0.02 * torch.randn(
        (l, num_adapters + 1, d, rank), generator=generator,
        device=generator.device,
    ).to(dtype)
    a = a.to(device if device is not None else generator.device)
    a[:, 0] = 0.0  # the base row stays an exact no-op
    b = torch.zeros((l, num_adapters + 1, rank, qkv_out), dtype=dtype,
                    device=a.device)
    return {"lora_qkv_a": a, "lora_qkv_b": b}


def lora_delta(
    x: torch.Tensor,  # [B, S, D] (normed activations)
    a: torch.Tensor,  # [N+1, D, r], one layer's slice
    b: torch.Tensor,  # [N+1, r, O]
    idx: torch.Tensor,  # [B] adapter ids (0 = base / no-op)
) -> torch.Tensor:  # [B, S, O]
    """Per-row adapter delta: x @ A[idx] @ B[idx], batched."""
    idx = idx.long()
    mid = torch.bmm(x, a.index_select(0, idx))  # [B, S, r]
    return torch.bmm(mid, b.index_select(0, idx))
