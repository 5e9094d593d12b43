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

`train_state_from_numpy` carries a reference `TrainState` across: its
params as above, and optax's `ScaleByAdamState` (`mu`, `nu`, `count`)
as the port's AdamW state (`exp_avg`, `exp_avg_sq`, `step`), leaf by
leaf through the same mapping, so a JAX run can continue in the port.
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


def _adam_state(opt_state: Any):
    """The `ScaleByAdamState` (a namedtuple with `mu`, `nu`, `count`) in
    an optax state: itself, or an element of the chain's tuple."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for sub in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def train_state_from_numpy(
    params_np: dict, opt_state_np: Any, step: int, cfg, device,
    dtype: Optional[torch.dtype] = None, learning_rate: float = 3e-4,
    weight_decay: float = 0.01, mesh=None,
):
    """A reference TrainState (its leaves turned into numpy arrays, as
    for `params_from_numpy`; `step` its step) → `training.TrainState` of
    model config `cfg` on `device`, sharded onto `mesh` when given. The
    AdamW step of every leaf is optax's `count`, which equals `step`."""
    from ggrmcp_tpu_torch.models import training

    adam = _adam_state(opt_state_np)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (mu, nu, count) in "
                         "the optimizer state")
    count = int(np.asarray(adam.count))
    if count != int(step):
        raise ValueError(f"TrainState.step {int(step)} != the optimizer's "
                         f"count {count}")
    params, mu, nu = (params_from_numpy(t, device, dtype)
                      for t in (params_np, adam.mu, adam.nu))
    return training.make_train_state(params, cfg, learning_rate,
                                     weight_decay, mesh, step=count,
                                     moments=(mu, nu))
