"""The port's sidecar on a unix-domain socket, against the reference's
(`tests/test_uds.py`): with `serving.uds_path` it binds `unix:{path}`
only and reports it as its target (port 0), a Generate over the socket
returns the reference sidecar's token ids on the same weights (greedy:
exact equality), `stop()` removes the socket file, and a path over 100
bytes is refused at parse time as the reference refuses it. Also the
`hf_checkpoint_optional` opt-in: an absent checkpoint directory serves
`serving.model` with random weights, loudly, only when asked."""

import asyncio
import logging
import os
import tempfile

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.core.config import default as jdefault
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    ServingConfig,
    config_from_dict,
)
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
SMALL = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)
PROMPTS = ("hello over a socket", "x" * 40, "abc")


def _sock(name: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"ggrmcp-tuds-{name}-{os.getpid()}.sock")


async def _generate(target: str) -> list[list[int]]:
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateResponse.FromString,
        )
        out = await asyncio.gather(*(
            call(serving_pb2.GenerateRequest(
                prompt=p, max_new_tokens=8, return_tokens=True))
            for p in PROMPTS))
    return [list(r.token_ids) for r in out]


async def test_sidecar_binds_uds_and_matches_reference():
    jpath, tpath = _sock("ref"), _sock("port")
    jside = JSidecar(
        JServing(mesh=MeshConfig(tensor=1), batching=JBatching(**SMALL),
                 uds_path=jpath),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
    )
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jside.generation.params), CPU)
    tside = Sidecar(
        ServingConfig(batching=BatchingConfig(**SMALL), uds_path=tpath),
        params=tparams, device="cpu")
    assert await jside.start() == 0
    try:
        assert await tside.start() == 0
        try:
            assert tside.port == 0 and tside.target == f"unix:{tpath}"
            assert os.path.exists(tpath)
            ref = await _generate(jside.target)
            got = await _generate(tside.target)
            assert got == ref and all(got)
        finally:
            await tside.stop()
        assert not os.path.exists(tpath)
    finally:
        await jside.stop()


def test_uds_path_length_refused_like_reference():
    path = "/tmp/" + "x" * 120
    with pytest.raises(ValueError, match="uds_path too long"):
        ServingConfig(uds_path=path)
    with pytest.raises(ValueError, match="uds_path too long"):
        config_from_dict({"serving": {"uds_path": path}})
    ref = jdefault()
    ref.serving.uds_path = path
    with pytest.raises(ValueError, match="uds_path too long"):
        ref.validate()
    # A path within the limit is accepted by both.
    assert ServingConfig(uds_path="/tmp/ggrmcp.sock").uds_path
    ref.serving.uds_path = "/tmp/ggrmcp.sock"
    ref.validate()


def test_absent_checkpoint_serves_random_only_when_optional(caplog):
    absent = os.path.join(tempfile.gettempdir(), f"no-ckpt-{os.getpid()}")
    with caplog.at_level(logging.WARNING, logger="ggrmcp.torch.sidecar"):
        side = Sidecar(ServingConfig(
            hf_checkpoint_path=absent, hf_checkpoint_optional=True,
            batching=BatchingConfig(**SMALL)), device="cpu")
    assert side.generation.cfg.name == "tiny-llama"
    assert any("unobtainable" in r.getMessage() for r in caplog.records)
    with pytest.raises(OSError):
        Sidecar(ServingConfig(hf_checkpoint_path=absent,
                              batching=BatchingConfig(**SMALL)),
                device="cpu")
