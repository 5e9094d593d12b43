"""Int8 weight-only quantization and the int8 KV leaf.

Port of `ggrmcp_tpu/ops/quant.py` (its TP-only `quantize_specs` is not
ported). The scheme, bit for bit the reference's:

- per-output-channel symmetric int8: `q = round(w / scale)` with
  `scale = max|w| / 127` over the contraction axis, computed in float32;
  the stored scale is rounded to the weight's dtype, while `q` was
  computed with the float32 one (dequantization multiplies by the
  stored scale, as the reference does);
- `matmul` casts the int8 weight to the activation dtype and applies the
  per-column scale to the product. XLA fuses the cast into the matmul;
  eager PyTorch materialises the cast weight on every call (a fused int8
  GEMM is a later performance item);
- embeddings quantize per row (one scale per token vector), since they
  are gathered, not contracted.

`QuantizedTensor` is a dataclass, not a tuple: indexing it raises
instead of quietly returning `q`. Ops over both leaves go through
`kv_map`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """A tensor stored int8 with its dequantization scale (the
    counterpart of the reference's `QuantizedArray`)."""

    q: torch.Tensor  # int8, the original shape
    scale: torch.Tensor  # original dtype; the quantization axis has size 1

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


TensorOrQuant = Union[torch.Tensor, QuantizedTensor]


def quantize(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric int8 quantization with the scale reduced over `axis`
    (default: the contraction axis of a [.., K, N] matmul weight, so one
    scale per output channel). The division is a true float32 division,
    as in the reference; a multiply by the reciprocal is not bitwise
    equal. The divisor is a tensor on w's device: divided by a Python
    scalar, PyTorch's CUDA kernel multiplies by the scalar's reciprocal,
    one ulp off the CPU's (and the reference's) quotient."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / torch.tensor(
        127.0, dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.to(w.dtype))


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    return qt.q.to(qt.scale.dtype) * qt.scale


def kv_map(fn: Callable, *kvs: TensorOrQuant) -> TensorOrQuant:
    """Apply a positional op to possibly-quantized tensors. An int8 KV
    cache stores values [.., S, KVH, D] and scales [.., S, KVH, 1];
    every cache bookkeeping op (row copy, slice, layer select) indexes
    leading axes only, so it applies to q and scale alike. Plain
    tensors pass straight to `fn`."""
    if isinstance(kvs[0], QuantizedTensor):
        return QuantizedTensor(
            q=fn(*(x.q for x in kvs)),
            scale=fn(*(x.scale for x in kvs)),
        )
    return fn(*kvs)


def matmul(x: torch.Tensor, w: TensorOrQuant) -> torch.Tensor:
    """`x @ w` for dense or quantized weights: for a QuantizedTensor the
    int8 weight is cast to x's dtype (there is no mixed int8 x bf16
    product) and the per-column scale multiplies the product."""
    if isinstance(w, QuantizedTensor):
        return (x @ w.q.to(x.dtype)) * w.scale
    return x @ w


def embed_lookup(
    table: TensorOrQuant, tokens: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Row gather from a dense or row-quantized [V, D] embedding."""
    tokens = tokens.long()
    if isinstance(table, QuantizedTensor):
        return table.q[tokens].to(dtype) * table.scale[tokens].to(dtype)
    return table.to(dtype)[tokens]


# ---------------------------------------------------------------------------
# Whole-model transforms
# ---------------------------------------------------------------------------

# Decoder matmul weights quantized per output channel (the contraction
# axis of the stacked [L, K, N] layout is -2). Only 3-D stacked leaves
# qualify, as in the reference (its MoE expert banks share these names
# but are 4-D and stay dense).
_LAYER_MATMULS = ("wqkv", "wo", "w_gate", "w_up", "w_down")


def _is_stacked_matmul(leaf: Any) -> bool:
    """A 3-D stacked weight, given as a tensor or as its shape."""
    shape = leaf.shape if isinstance(leaf, torch.Tensor) else leaf
    return isinstance(shape, tuple) and len(shape) == 3


def quantize_targets(params: dict[str, Any]) -> list[tuple[tuple, int]]:
    """The leaves `quantize_model` quantizes, as (path, axis): layer
    matmuls and lm_head per output channel (axis -2), the embedding per
    row (axis -1). Norms stay dense. `params` holds tensors, or their
    shapes as tuples."""
    targets = [
        (("layers", name), -2) for name in _LAYER_MATMULS
        if _is_stacked_matmul(params["layers"].get(name))
    ]
    if "lm_head" in params:
        targets.append((("lm_head",), -2))
    if "embed" in params:
        targets.append((("embed",), -1))
    return targets


def quantize_model(params: dict[str, Any]) -> dict[str, Any]:
    """Quantize a decoder param tree for serving; returns a new tree (the
    input's dense leaves are left as they are)."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for path, axis in quantize_targets(params):
        parent = out if len(path) == 1 else out["layers"]
        parent[path[-1]] = quantize(parent[path[-1]], axis=axis)
    return out


def quantized_nbytes(params: dict[str, Any]) -> int:
    """Bytes of every leaf, a quantized leaf's scales included."""
    total = 0
    for value in params.values():
        if isinstance(value, dict):
            total += quantized_nbytes(value)
        else:
            total += value.nbytes
    return total
