"""numpy array ↔ `serving_pb2.Tensor` for the serving plane. A copy of
`to_proto` / `from_proto` from `ggrmcp_tpu/serving/tensors.py`: large
payloads ride raw little-endian bytes, small ones may use the repeated
fields (JSON-friendly, as the gateway sends them)."""

from __future__ import annotations

import numpy as np

from ggrmcp_tpu_torch.rpc.pb import serving_pb2

_DTYPES = {
    "float32": np.float32,
    "bfloat16": None,  # handled via a uint16 view
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
    "uint8": np.uint8,
    "int8": np.int8,
}


def to_proto(array: np.ndarray) -> serving_pb2.Tensor:
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


def from_proto(proto: serving_pb2.Tensor) -> np.ndarray:
    shape = tuple(proto.shape)
    if proto.data:
        if proto.dtype == "bfloat16":
            import ml_dtypes

            raw = np.frombuffer(proto.data, dtype=np.uint16)
            return raw.view(ml_dtypes.bfloat16).reshape(shape)
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
