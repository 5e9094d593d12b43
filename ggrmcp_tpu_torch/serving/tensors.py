"""numpy array / torch tensor ↔ `serving_pb2.Tensor` for the serving
plane, and the KV page-content codec on top of it. A copy of
`ggrmcp_tpu/serving/tensors.py` whose wire format is byte for byte the
reference's: large payloads ride raw little-endian bytes, small ones may
use the repeated fields (JSON-friendly, as the gateway sends them).

bfloat16 needs no `ml_dtypes` (absent on the machine with the card): a
bf16 payload decodes to a `torch.bfloat16` tensor built from its raw
16-bit words, and a torch bf16 tensor encodes from its int16 view. Every
other dtype decodes to a numpy array, as in the reference. A replica of
either package can therefore read pages the other shipped.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ggrmcp_tpu_torch.rpc.pb import serving_pb2

ArrayLike = Union[np.ndarray, torch.Tensor]

_DTYPES = {
    "float32": np.float32,
    "bfloat16": None,  # handled via a 16-bit view
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
    "uint8": np.uint8,
    # int8 KV pages ride the TransferKV plane verbatim (half the bytes
    # of bf16); without this entry to_proto would widen them to float32.
    "int8": np.int8,
}


def to_proto(array: ArrayLike) -> serving_pb2.Tensor:
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return serving_pb2.Tensor(
                dtype="bfloat16", shape=list(t.shape),
                data=t.view(torch.int16).numpy().tobytes(),
            )
        array = t.numpy()
    array = np.asarray(array)
    dtype_name = str(array.dtype)
    if dtype_name == "bfloat16":
        data = array.view(np.uint16).tobytes()
    else:
        if dtype_name not in _DTYPES:
            array = array.astype(np.float32)
            dtype_name = "float32"
        data = array.tobytes()
    return serving_pb2.Tensor(
        dtype=dtype_name, shape=list(array.shape), data=data
    )


def from_proto(proto: serving_pb2.Tensor) -> ArrayLike:
    """A numpy array, or a torch.bfloat16 tensor for a bf16 payload."""
    shape = tuple(proto.shape)
    if proto.data:
        if proto.dtype == "bfloat16":
            raw = np.frombuffer(proto.data, dtype=np.int16).reshape(shape)
            return torch.from_numpy(raw.copy()).view(torch.bfloat16)
        np_dtype = _DTYPES.get(proto.dtype)
        if np_dtype is None:
            raise ValueError(f"unsupported tensor dtype: {proto.dtype!r}")
        return np.frombuffer(proto.data, dtype=np_dtype).reshape(shape)
    if proto.int_values:
        base = np.array(proto.int_values, dtype=np.int64)
        if proto.dtype == "int32":
            base = base.astype(np.int32)
        return base.reshape(shape) if shape else base
    if proto.float_values:
        return np.array(proto.float_values, dtype=np.float32).reshape(
            shape if shape else (len(proto.float_values),)
        )
    return np.zeros(shape, dtype=_DTYPES.get(proto.dtype) or np.float32)


# ---------------------------------------------------------------------
# KV page-content codec: ONE pack/unpack for every consumer that moves
# page KV through host memory, the TransferKV wire chunks and the host
# page pool (serving/host_pool.py, its file tier included). Both ride
# serving_pb2.KVPagePayload built from to_proto / from_proto above, so
# the two paths cannot drift in format, int8 scales included.
# ---------------------------------------------------------------------


def kv_pages_to_payload(
    k: ArrayLike,
    v: ArrayLike,
    k_scale: Optional[ArrayLike] = None,
    v_scale: Optional[ArrayLike] = None,
) -> serving_pb2.KVPagePayload:
    """[L, n, P, KVH, Dh] K/V page arrays (+ int8 scales) → the shared
    page-content proto. int8 KV MUST carry both scales; mixing is a
    caller bug, surfaced here rather than as a garbled unpack."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "int8 KV pages need BOTH k_scale and v_scale (or neither)"
        )
    payload = serving_pb2.KVPagePayload(k=to_proto(k), v=to_proto(v))
    if k_scale is not None:
        payload.k_scales.CopyFrom(to_proto(k_scale))
        payload.v_scales.CopyFrom(to_proto(v_scale))
    return payload


def kv_pages_from_payload(
    payload: serving_pb2.KVPagePayload,
) -> tuple[
    ArrayLike, ArrayLike, Optional[ArrayLike], Optional[ArrayLike]
]:
    """Inverse of kv_pages_to_payload: (k, v, k_scale, v_scale) with
    scales None for unquantized KV."""
    k = from_proto(payload.k)
    v = from_proto(payload.v)
    if payload.HasField("k_scales"):
        return k, v, from_proto(payload.k_scales), from_proto(
            payload.v_scales
        )
    return k, v, None, None


def pack_kv_pages(
    k: ArrayLike,
    v: ArrayLike,
    k_scale: Optional[ArrayLike] = None,
    v_scale: Optional[ArrayLike] = None,
) -> bytes:
    """Serialized KVPagePayload: the host pool's storage format (RAM
    entries and file-tier records hold exactly these bytes)."""
    return kv_pages_to_payload(k, v, k_scale, v_scale).SerializeToString()


def unpack_kv_pages(
    blob: bytes,
) -> tuple[
    ArrayLike, ArrayLike, Optional[ArrayLike], Optional[ArrayLike]
]:
    payload = serving_pb2.KVPagePayload()
    payload.ParseFromString(blob)
    return kv_pages_from_payload(payload)
