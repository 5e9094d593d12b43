"""Int8 weight-only quantization and the int8 KV leaf.

Port of `ggrmcp_tpu/ops/quant.py`. The scheme, bit for bit the
reference's:

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
`kv_map`, which also maps over a mesh's per-shard parts
(parallel/collectives.py `Sharded`; a sharded quantized leaf holds a
`Sharded` q and scale). `quantize_sharded` quantizes such a leaf to the
bits of quantizing the whole one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import Sharded


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
    return quantize_with(w, axis, None)


def quantize_with(w: torch.Tensor, axis: int,
                  amax: "torch.Tensor | None") -> QuantizedTensor:
    """`quantize(w, axis)`, or with a given float32 per-channel max (a
    sharded leaf's, taken over every shard)."""
    w32 = w.float()
    if amax is None:
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
    leading axes only, so it applies to q and scale alike. A mesh
    leaf's parts (`Sharded`) are mapped shard by shard, once per stored
    tensor. Plain tensors pass straight to `fn`."""
    if isinstance(kvs[0], QuantizedTensor):
        return QuantizedTensor(
            q=kv_map(fn, *(x.q for x in kvs)),
            scale=kv_map(fn, *(x.scale for x in kvs)),
        )
    if isinstance(kvs[0], Sharded):
        return kvs[0].map(fn, *kvs[1:])
    return fn(*kvs)


def matmul(x: torch.Tensor, w: TensorOrQuant,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`x @ w` for dense or quantized weights: for a QuantizedTensor the
    int8 weight is cast to x's dtype (there is no mixed int8 x bf16
    product) and the per-column scale multiplies the product.
    `out_dtype` float32 keeps a bf16 product's float32 accumulator
    unrounded (a row-parallel partial, rounded once after its sum)."""
    if isinstance(w, QuantizedTensor):
        return matmul(x, w.q.to(x.dtype), out_dtype) * w.scale
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    graph = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.device.type == "cuda" and not graph:
        y = torch.mm(x2, w, out_dtype=out_dtype)
    else:
        # mm's out_dtype has no CPU kernel and no derivative; the
        # narrower type's products are exact in the wider one.
        y = x2.to(out_dtype) @ w.to(out_dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


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
    """A 3-D stacked weight, given as a tensor (a mesh's `Sharded` too)
    or as its shape."""
    shape = leaf.shape if isinstance(leaf, (torch.Tensor, Sharded)) else leaf
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


def quantize_specs(specs: dict[str, Any]) -> dict[str, Any]:
    """Mirror `quantize_model` over a spec tree: each quantized leaf's
    spec applies to its q and its scale alike (the scale's size-1 axis
    is replicated by `compatible_spec`). 3-D-ness is keyed off the spec
    length, as in the reference."""
    out = dict(specs)
    layers = dict(specs["layers"])
    for name in _LAYER_MATMULS:
        if name in layers and len(tuple(layers[name])) == 3:
            layers[name] = QuantizedTensor(q=layers[name], scale=layers[name])
    out["layers"] = layers
    for name in ("lm_head", "embed"):
        if name in out:
            out[name] = QuantizedTensor(q=out[name], scale=out[name])
    return out


def quantize_sharded(w: Sharded, axis: int, quantize_part=None
                     ) -> QuantizedTensor:
    """`quantize(whole, axis)` of a sharded leaf, shard by shard, to the
    same bits: where the shards split the reduced axis (a row-parallel
    weight), the per-channel max is taken, in float32, over the shards
    that hold the same block of every other dim (a stage's layers, say)
    before the scale is formed; the scale (one per channel) is then
    replicated over the reduced axis. `quantize_part(t, axis, amax)`
    quantizes one part (default: whole)."""
    groups = _reduction_groups(w, axis)
    amax: dict[int, torch.Tensor] = {}
    for group in groups.values():
        dev = w.parts[group[0]].device
        m = None
        for p in {id(w.parts[i]): w.parts[i] for i in group}.values():
            a = p.float().abs().amax(dim=axis, keepdim=True).to(dev)
            m = a if m is None else torch.maximum(m, a)
        for i in group:
            amax[i] = m
    done: dict[int, QuantizedTensor] = {}
    qs, scales = [], []
    for i, p in enumerate(w.parts):
        if id(p) not in done:
            done[id(p)] = (quantize_part or quantize_with)(
                p, axis, amax[i].to(p.device) if i in amax else None)
        qs.append(done[id(p)].q)
        scales.append(done[id(p)].scale)
    scale_factors = tuple(1 if i == len(w.factors) + axis else f
                          for i, f in enumerate(w.factors))
    scale_full = None
    if w.full is not None:
        scale_full = list(w.full)
        scale_full[axis] = 1
        scale_full = torch.Size(scale_full)
    scale_spec = None
    if w.spec is not None:
        scale_spec = list(w.spec)
        scale_spec[axis] = None
        scale_spec = tuple(scale_spec)
    return QuantizedTensor(
        q=Sharded(tuple(qs), w.factors, w.mesh, w.full, spec=w.spec),
        scale=Sharded(tuple(scales), scale_factors, w.mesh, scale_full,
                      spec=scale_spec))


def _reduction_groups(w: Sharded, axis: int) -> dict:
    """The coordinates whose parts one per-channel max spans, by the
    block they hold of every dim but `axis`, read from the spec the
    leaf was placed by ({} when no shard splits `axis`: each part is
    reduced whole)."""
    if w.factors[axis] == 1:
        return {}
    if w.spec is None:
        raise ValueError("quantize_sharded: a leaf split on its reduced "
                         "axis needs its placement spec (Sharded.spec)")
    mesh = w.mesh
    dim = len(w.spec) + axis if axis < 0 else axis
    groups: dict = {}
    for i in range(len(w.parts)):
        coord = mesh.coord(i)
        key = tuple(mesh_mod.block_index(mesh, e, coord)
                    for d, e in enumerate(w.spec) if d != dim)
        groups.setdefault(key, []).append(i)
    return groups


def quantized_nbytes(params: dict[str, Any]) -> int:
    """Bytes of every leaf, a quantized leaf's scales included."""
    total = 0
    for value in params.values():
        if isinstance(value, dict):
            total += quantized_nbytes(value)
        else:
            total += value.nbytes
    return total
