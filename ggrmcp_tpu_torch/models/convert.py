"""The one way weights cross from the reference into this package.

`params_from_numpy` takes the reference's parameter tree after the
caller has turned every leaf into a numpy array (for a JAX tree:
`jax.tree.map(np.asarray, params)`) and returns this package's dict of
tensors, for either family (a Llama or a BERT tree). Both packages use
the same stacked [L, in, out] layout (models/llama.py, models/bert.py),
so no leaf is transposed or reshaped. A quantized leaf of the reference
(a namedtuple with fields `q` and `scale`, which `jax.tree.map` keeps)
becomes a `QuantizedTensor`, its int8 values kept int8. A tree with
LoRA factor stacks (`layers["lora_qkv_a"]` [L, N+1, D, r],
`layers["lora_qkv_b"]` [L, N+1, r, O], ops/lora.py) carries them across
as it does every other stacked layer leaf. A speculative draft's tree (a
reference engine's `draft_params`) converts the same way and reaches
`GenerationEngine` as its `draft_params`. A MoE tree (models/moe.py)
crosses the same way; its `router` leaves stay float32 whatever `dtype`
is, as the reference keeps them (a bf16 router would route otherwise).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ggrmcp_tpu_torch.models.common import FLOAT32_LEAVES
from ggrmcp_tpu_torch.ops.quant import QuantizedTensor


def _leaf(a: Any, device: torch.device, dtype: Optional[torch.dtype]):
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy;
        # widening to float32 is exact.
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _is_quantized(value: Any) -> bool:
    return isinstance(value, tuple) and getattr(value, "_fields", None) == (
        "q", "scale"
    )


def params_from_numpy(
    tree: dict, device, dtype: Optional[torch.dtype] = None
) -> dict:
    """Nested dict of numpy arrays → the same nesting of tensors on
    `device`; floating leaves (a quantized leaf's scale too) cast to
    `dtype` when given, except the float32 leaves of
    `common.FLOAT32_LEAVES`."""
    dev = torch.device(device)

    def convert(key, value):
        if isinstance(value, dict):
            return params_from_numpy(value, dev, dtype)
        if _is_quantized(value):
            return QuantizedTensor(
                q=_leaf(value.q, dev, None), scale=_leaf(value.scale, dev, dtype)
            )
        if key in FLOAT32_LEAVES:
            return _leaf(value, dev, torch.float32)
        return _leaf(value, dev, dtype)

    return {key: convert(key, value) for key, value in tree.items()}
