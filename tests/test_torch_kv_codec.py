"""The port's tensor and KV page codec (serving/tensors.py) against the
JAX package's.

- Round trips of float32, bfloat16 and int8 pages with their scales are
  bit for bit.
- The serialized payloads equal the reference's `pack_kv_pages` of the
  same arrays byte for byte, so a replica of either package reads pages
  the other shipped or demoted (each side decodes the other's bytes).
- bfloat16 decodes with `ml_dtypes` blocked, in a fresh interpreter (the
  machine with the card has no `ml_dtypes`).
"""

import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from ggrmcp_tpu.rpc.pb import serving_pb2 as jpb
from ggrmcp_tpu.serving import tensors as jt
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import tensors as tt
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 3, 8, 2, 16)  # [L, n, P, KVH, Dh]


def _pages(dtype: str, seed: int = 0):
    """(reference arrays, port arrays): the same values, numpy for the
    reference (ml_dtypes for bf16), torch bf16 for the port's bf16."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(SHAPE).astype(np.float32)
    v = rng.standard_normal(SHAPE).astype(np.float32)
    if dtype == "float32":
        return (k, v, None, None), (k, v, None, None)
    if dtype == "bfloat16":
        ref = (k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16))
        port = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
        return ref + (None, None), port + (None, None)
    q = rng.integers(-127, 128, SHAPE).astype(np.int8)
    qv = rng.integers(-127, 128, SHAPE).astype(np.int8)
    scale_shape = SHAPE[:-1] + (1,)
    ks = rng.random(scale_shape).astype(np.float32)
    vs = rng.random(scale_shape).astype(np.float32)
    return (q, qv, ks, vs), (torch.from_numpy(q), torch.from_numpy(qv),
                             torch.from_numpy(ks), vs)


def _as_np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pack_is_byte_identical_to_reference(dtype):
    ref, port = _pages(dtype)
    assert tt.pack_kv_pages(*port) == jt.pack_kv_pages(*ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_round_trip_bit_identical(dtype):
    _, port = _pages(dtype, seed=1)
    got = tt.unpack_kv_pages(tt.pack_kv_pages(*port))
    for want, have in zip(port, got):
        if want is None:
            assert have is None
            continue
        assert tuple(have.shape) == tuple(want.shape)
        assert np.array_equal(_as_np(have), _as_np(want))
    if dtype == "bfloat16":
        assert isinstance(got[0], torch.Tensor)
        assert got[0].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_each_package_decodes_the_others_pages(dtype):
    ref, port = _pages(dtype, seed=2)
    from_ref = tt.unpack_kv_pages(jt.pack_kv_pages(*ref))
    from_port = jt.unpack_kv_pages(tt.pack_kv_pages(*port))
    for a, b, want in zip(from_ref, from_port, ref):
        if want is None:
            assert a is None and b is None
            continue
        assert np.array_equal(_as_np(a), _as_np(want))
        assert np.array_equal(_as_np(b), _as_np(want))


def test_mixed_scales_rejected():
    _, (k, v, ks, _) = _pages("int8")
    with pytest.raises(ValueError, match="BOTH"):
        tt.kv_pages_to_payload(k, v, ks, None)


def test_one_payload_message_for_wire_and_host():
    """The TransferKV chunk carries exactly the payload's tensors: the
    host tier's storage format and the wire are one codec."""
    _, port = _pages("int8", seed=3)
    payload = tt.kv_pages_to_payload(*port)
    chunk = serving_pb2.KVTransferRequest(
        k_pages=payload.k, v_pages=payload.v, k_scales=payload.k_scales,
        v_scales=payload.v_scales)
    again = serving_pb2.KVPagePayload(
        k=chunk.k_pages, v=chunk.v_pages, k_scales=chunk.k_scales,
        v_scales=chunk.v_scales)
    assert again.SerializeToString() == payload.SerializeToString()
    ref = jpb.KVPagePayload()
    ref.ParseFromString(payload.SerializeToString())
    assert ref.k.dtype == "int8" and list(ref.k_scales.shape) == list(
        SHAPE[:-1] + (1,))


def test_plain_tensors_match_reference():
    """The request-side codec: int ids, float vectors and the repeated
    fields decode as in the reference; a torch int tensor encodes like
    its numpy twin."""
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert (tt.to_proto(torch.from_numpy(ids)).SerializeToString()
            == jt.to_proto(ids).SerializeToString())
    for proto in (
        serving_pb2.Tensor(dtype="int32", shape=[2, 2], int_values=[1, 2, 3, 4]),
        serving_pb2.Tensor(float_values=[0.5, 1.5]),
        serving_pb2.Tensor(dtype="int64", shape=[3]),
        tt.to_proto(np.float64([1.0, 2.0])),
    ):
        got, want = tt.from_proto(proto), jt.from_proto(proto)
        assert got.dtype == want.dtype and np.array_equal(got, want)


_BLOCKED = """
import sys
sys.modules["ml_dtypes"] = None
import json
import torch
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import tensors
blob = open(sys.argv[1], "rb").read()
k, v, ks, vs = tensors.unpack_kv_pages(blob)
t = tensors.from_proto(serving_pb2.Tensor(
    dtype="bfloat16", shape=[2], data=bytes([0x80, 0x3f, 0x00, 0xc0])))
again = tensors.pack_kv_pages(k, v)
print(json.dumps({
    "dtype": str(k.dtype), "shape": list(k.shape),
    "sum": float(k.float().sum() + v.float().sum()),
    "scales": ks is None and vs is None,
    "tensor": t.float().tolist(),
    "repack": again == blob,
    "ml_dtypes": "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"]
    is not None,
}))
"""


def test_bf16_decodes_with_ml_dtypes_blocked(tmp_path):
    ref, _ = _pages("bfloat16", seed=4)
    blob = jt.pack_kv_pages(*ref)
    path = tmp_path / "pages.bin"
    path.write_bytes(blob)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    want = float(ref[0].astype(np.float32).sum()
                 + ref[1].astype(np.float32).sum())
    assert got["dtype"] == "torch.bfloat16" and got["shape"] == list(SHAPE)
    assert got["sum"] == pytest.approx(want, rel=1e-6)
    assert got["scales"] and got["repack"] and not got["ml_dtypes"]
    assert got["tensor"] == [1.0, -2.0]
