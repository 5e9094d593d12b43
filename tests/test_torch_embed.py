"""Embedding parity: the PyTorch port's EmbeddingEngine and embed
sidecar against the reference's, with the same bert-tiny weights (the
JAX init tree crossed through `params_from_numpy`), plus one MCP
tools/call through the unchanged reference gateway, and the CLI.

Tolerance: 1e-5 absolute on the float32 embeddings (both sides compute
in float32 and sum in a different order); token handling is exact.
"""

import base64
import json

import grpc
import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import bert as jb
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.engine import EmbeddingEngine as JEmbedding
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar
from ggrmcp_tpu_torch import __main__ as cli
from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models.common import param_bytes
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import tensors
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar

ATOL = 1e-5
CPU = torch.device("cpu")
MODEL = "bert-tiny"
# Interior zeros are real ids; only trailing zeros are padding.
TEXTS = ["hello embeddings", "", "a much longer text " * 4, "x"]


def _single_mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


@pytest.fixture(scope="module")
def engines():
    cfg = jb.CONFIGS[MODEL]
    jparams = jb.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JEmbedding(cfg, JServing(mesh=MeshConfig(tensor=1)),
                      mesh=_single_mesh(), params=jparams)
    teng = EmbeddingEngine(
        tb.CONFIGS[MODEL],
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), CPU),
        device="cpu",
    )
    return jeng, teng


def _token_lists(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 30522, n).tolist() for n in lengths]


@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
def test_engine_matches_reference(engines, pooling):
    jeng, teng = engines
    lists = _token_lists((5, 40, 1, 17, 100, 33))
    ref = jeng.embed(lists, pooling)
    out = teng.embed(lists, pooling)
    assert out.dtype == np.float32 and out.shape == ref.shape == (6, 128)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert tatt.flash_attention.launches == 0  # CPU: plain versions only


@pytest.mark.parametrize("max_length", [0, 10, 64])
def test_engine_chunks_and_truncates_like_reference(engines, max_length):
    """Batches past MAX_CHUNK rows run in chunks (lowered to 3 here, on
    both engines); `max_length` truncates every row."""
    jeng, teng = engines
    lists = _token_lists((7, 30, 12, 64, 3, 9, 80), seed=1)
    ref_whole = jeng.embed(lists, "mean", max_length)
    jeng.MAX_CHUNK = teng.MAX_CHUNK = 3
    try:
        ref = jeng.embed(lists, "mean", max_length)
        out = teng.embed(lists, "mean", max_length)
    finally:
        del jeng.MAX_CHUNK, teng.MAX_CHUNK
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # Chunking changes the padding, not the vectors.
    np.testing.assert_allclose(out, ref_whole, atol=ATOL, rtol=0)
    if max_length:
        short = teng.embed([ids[:max_length] for ids in lists], "mean")
        np.testing.assert_allclose(out, short, atol=ATOL, rtol=0)


def test_engine_model_info(engines):
    jeng, teng = engines
    info, ref = teng.model_info(), jeng.model_info()
    assert info["family"] == ref["family"] == "bert"
    for key in ("model_id", "num_params_million", "max_seq_len", "dtype"):
        assert info[key] == ref[key], key
    assert info["platform"] == "cpu"
    assert teng.weight_bytes() == param_bytes(teng.params) > 0


def test_tensor_proto_round_trip():
    for arr in (np.arange(12, dtype=np.int32).reshape(3, 4),
                np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3),
                np.array([1, 0, 5], dtype=np.int64)):
        back = tensors.from_proto(tensors.to_proto(arr))
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    ints = serving_pb2.Tensor(dtype="int32", shape=[2, 2],
                              int_values=[1, 2, 3, 0])
    np.testing.assert_array_equal(tensors.from_proto(ints), [[1, 2], [3, 0]])
    assert tensors.from_proto(ints).dtype == np.int32


def _stub(channel, method, req_cls, resp_cls):
    return channel.unary_unary(
        method, request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


async def _embed_calls(target):
    """Embed by texts (three poolings), by token_ids with trailing pads,
    and the two INVALID_ARGUMENT aborts."""
    async with grpc.aio.insecure_channel(target) as channel:
        embed = _stub(channel, "/ggrmcp.tpu.EmbedService/Embed",
                      serving_pb2.EmbedRequest, serving_pb2.EmbedResponse)
        out = {}
        for pooling in ("mean", "cls", "max"):
            resp = await embed(serving_pb2.EmbedRequest(
                texts=TEXTS, pooling=pooling))
            out[pooling] = tensors.from_proto(resp.embeddings)
        ids = np.array([[5, 0, 7, 9, 0, 0], [3, 4, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0]], np.int32)
        resp = await embed(serving_pb2.EmbedRequest(
            token_ids=tensors.to_proto(ids), max_length=3))
        out["token_ids"] = tensors.from_proto(resp.embeddings)
        out["model_id"] = resp.model_id
        errors = []
        for req in (serving_pb2.EmbedRequest(texts=["a"], pooling="sum"),
                    serving_pb2.EmbedRequest()):
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await embed(req)
            errors.append((err.value.code(), err.value.details()))
        out["errors"] = errors
        info = await _stub(
            channel, "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
            serving_pb2.ModelInfoRequest, serving_pb2.ModelInfoResponse,
        )(serving_pb2.ModelInfoRequest())
        stats = await _stub(
            channel, "/ggrmcp.tpu.ModelInfoService/GetServingStats",
            serving_pb2.ServingStatsRequest, serving_pb2.ServingStatsResponse,
        )(serving_pb2.ServingStatsRequest())
    return out, info, stats


async def _gateway(target, calls):
    import aiohttp

    from ggrmcp_tpu.core import config as cfgmod
    from ggrmcp_tpu.gateway.app import Gateway

    cfg = cfgmod.default()
    cfg.server.host = "127.0.0.1"
    cfg.server.port = 0
    cfg.grpc.reconnect.enabled = False
    gw = Gateway(cfg, targets=[target])
    await gw.start()
    try:
        async with aiohttp.ClientSession(
            base_url=f"http://127.0.0.1:{gw.port}"
        ) as client:
            results = []
            for i, (method, params) in enumerate(calls):
                resp = await client.post("/", json={
                    "jsonrpc": "2.0", "method": method, "id": i,
                    "params": params,
                })
                results.append(await resp.json())
            return results
    finally:
        await gw.stop()


# Services of the reference sidecar that the port does not serve yet.
UNPORTED_TOOLS = ("ggrmcp_tpu_debugservice_", "ggrmcp_tpu_kvtransferservice_")


async def test_embed_sidecar_and_gateway_match_reference():
    """The port's embed sidecar returns the JAX sidecar's vectors (same
    weights) for texts and token_ids, the same INVALID_ARGUMENT aborts,
    family bert, and its weights' bytes in GetServingStats; behind the
    unchanged gateway it lists the reference's tool names (no Generate
    tool) and one tools/call of the embed tool returns the JAX
    sidecar's vectors."""
    jside = JSidecar(JServing(model=MODEL, mesh=MeshConfig(tensor=1)),
                     mesh=_single_mesh())
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jside.embedding.params), CPU
    )
    tside = Sidecar(ServingConfig(model=MODEL), params=tparams, device="cpu")
    assert tside.generation is None and tside.batcher is None
    jport = await jside.start(0)
    tport = await tside.start(0)
    try:
        ref, _, _ = await _embed_calls(f"localhost:{jport}")
        out, info, stats = await _embed_calls(f"localhost:{tport}")
        for key in ("mean", "cls", "max", "token_ids"):
            assert out[key].dtype == np.float32, key
            np.testing.assert_allclose(out[key], ref[key], atol=ATOL, rtol=0,
                                       err_msg=key)
        assert out["token_ids"].shape == (3, 128)
        assert out["model_id"] == ref["model_id"] == MODEL
        assert out["errors"] == ref["errors"]
        assert out["errors"][0][0] == grpc.StatusCode.INVALID_ARGUMENT
        assert info.family == "bert" and info.model_id == MODEL
        assert stats.memory_weights_bytes == param_bytes(tparams)
        assert stats.total_slots == 0

        list_call = ("tools/list", {})
        embed_call = ("tools/call", {
            "name": "ggrmcp_tpu_embedservice_embed",
            "arguments": {"texts": TEXTS[:2], "pooling": "max"},
        })
        (ref_list,) = await _gateway(f"localhost:{jport}", [list_call])
        got_list, got = await _gateway(f"localhost:{tport}",
                                       [list_call, embed_call])
    finally:
        await tside.stop()
        await jside.stop()
    ref_tools = {t["name"] for t in ref_list["result"]["tools"]}
    tools = {t["name"] for t in got_list["result"]["tools"]}
    assert tools == {t for t in ref_tools if not t.startswith(UNPORTED_TOOLS)}
    assert "ggrmcp_tpu_embedservice_embed" in tools
    assert not any("generateservice" in t for t in tools)
    assert "error" not in got, got
    payload = json.loads(got["result"]["content"][0]["text"])
    emb = payload["embeddings"]
    vectors = np.frombuffer(base64.b64decode(emb["data"]),
                            np.float32).reshape([int(d) for d in emb["shape"]])
    np.testing.assert_allclose(vectors, ref["max"][:2], atol=ATOL, rtol=0)


def test_cli_parses_the_new_flags():
    args = cli.build_parser().parse_args([
        "sidecar", "--model", "bert-base", "--hf-checkpoint", "/ck",
        "--tokenizer", "/ck/tokenizer.json", "--port", "7",
    ])
    assert (args.model, args.hf_checkpoint, args.tokenizer, args.port) == (
        "bert-base", "/ck", "/ck/tokenizer.json", 7)
    assert args.device is None
    defaults = cli.build_parser().parse_args(["sidecar"])
    assert (defaults.hf_checkpoint, defaults.tokenizer) == ("", "")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["sidecar", "--model", "moe-tiny"])


def test_cli_asks_for_cuda_unless_told_cpu(monkeypatch):
    """Without --device the sidecar asks for CUDA, which raises here;
    `--device cpu` is the only way onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sidecar", "--model", MODEL, "--port", "0"])

    started = {}

    async def fake_serve(args):
        side = Sidecar(ServingConfig(model=args.model), device=args.device)
        started["device"] = side.embedding.device
        started["family"] = side.family

    monkeypatch.setattr(cli, "_serve", fake_serve)
    assert cli.main(["sidecar", "--model", MODEL, "--device", "cpu"]) == 0
    assert started == {"device": CPU, "family": "bert"}
