"""HF checkpoint parity: the PyTorch port's safetensors reader, config
derivation, loader and HF tokenizer against the `safetensors` package
and the reference (`ggrmcp_tpu/serving/{weights,tokenizer}.py`), on tiny
Llama and Mistral checkpoints built here with `transformers`, plus an
HF-checkpoint generate sidecar on both packages.

Tolerance: bitwise for tensors, configs and token ids; 1e-5 absolute on
float32 logits (both sides compute in float32 and sum in a different
order).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import grpc
import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
st = pytest.importorskip("safetensors.torch")

import chip_smoke  # noqa: E402
from ggrmcp_tpu.core.config import MeshConfig  # noqa: E402
from ggrmcp_tpu.core.config import ServingConfig as JServing  # noqa: E402
from ggrmcp_tpu.models import llama as jl  # noqa: E402
from ggrmcp_tpu.parallel import mesh as mesh_mod  # noqa: E402
from ggrmcp_tpu.serving import tokenizer as jtok  # noqa: E402
from ggrmcp_tpu.serving import weights as jw  # noqa: E402
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine  # noqa: E402
from ggrmcp_tpu.serving.sidecar import Sidecar as JSidecar  # noqa: E402
from ggrmcp_tpu_torch.core.config import ServingConfig  # noqa: E402
from ggrmcp_tpu_torch.models import llama as tl  # noqa: E402
from ggrmcp_tpu_torch.rpc.pb import serving_pb2  # noqa: E402
from ggrmcp_tpu_torch.serving import safetensors_io  # noqa: E402
from ggrmcp_tpu_torch.serving import tokenizer as ttok  # noqa: E402
from ggrmcp_tpu_torch.serving import weights as tw  # noqa: E402
from ggrmcp_tpu_torch.serving.engine import GenerationEngine  # noqa: E402
from ggrmcp_tpu_torch.serving.sidecar import Sidecar  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
CPU = torch.device("cpu")
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}


def _hf_model(path, mistral=False, tied=False, rope_scaling=None,
              dtype=torch.float32):
    """A tiny random HF checkpoint written by `save_pretrained`."""
    kind = "Mistral" if mistral else "Llama"
    extra = dict(sliding_window=4) if mistral else {}
    cfg = getattr(transformers, f"{kind}Config")(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tied, rope_scaling=rope_scaling, **extra,
    )
    torch.manual_seed(0)
    model = getattr(transformers, f"{kind}ForCausalLM")(cfg).to(dtype)
    model.save_pretrained(path, safe_serialization=True)
    return str(path)


def _shard(path):
    """Split the checkpoint's one file into two with an index."""
    single = os.path.join(path, "model.safetensors")
    tensors = st.load_file(single)
    names = sorted(tensors)
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2],
                              names[len(names) // 2:])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        st.save_file({n: tensors[n] for n in part},
                     os.path.join(path, fname))
        weight_map.update({n: fname for n in part})
    os.remove(single)
    with open(os.path.join(path, safetensors_io.INDEX), "w") as fh:
        json.dump({"weight_map": weight_map}, fh)
    return path


CHECKPOINTS = {
    "llama_f32": lambda p: _hf_model(p),
    "llama_bf16": lambda p: _hf_model(p, dtype=torch.bfloat16),
    "llama_f16": lambda p: _hf_model(p, dtype=torch.float16),
    "tied": lambda p: _hf_model(p, tied=True),
    "mistral": lambda p: _hf_model(p, mistral=True),
    "rope_llama3": lambda p: _hf_model(p, rope_scaling=LLAMA3_SCALING),
    "sharded": lambda p: _shard(_hf_model(p, dtype=torch.bfloat16)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {name: make(root / name) for name, make in CHECKPOINTS.items()}


# -- the reader ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["F32", "BF16", "F16"])
def test_reader_matches_safetensors_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn((3, 5), generator=g).to(dtype),
        "b": torch.randn((7,), generator=g).to(dtype),
        "c.stacked": torch.randn((2, 3, 4), generator=g).to(dtype),
        "empty": torch.zeros((0, 4), dtype=dtype),
    }
    path = str(tmp_path / "t.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    with safetensors_io.SafetensorsFile(path) as f:
        assert set(f.entries) == set(tensors)
        got = {name: f.read(name, CPU) for name in tensors}
    for name, t in tensors.items():
        assert got[name].dtype == dtype and torch.equal(got[name], t), name
    # The reads own their memory: the file is unmapped, they stay valid.
    assert torch.equal(got["b"] * 1, tensors["b"])


def test_chip_smoke_writer_reads_back(tmp_path):
    """chip_smoke.py's own writer (the card has no `safetensors`) writes
    files the package and the port's reader both read back bitwise."""
    g = torch.Generator().manual_seed(1)
    tensors = {"x": torch.randn((4, 6), generator=g).to(torch.bfloat16),
               "y": torch.randn((5,), generator=g),
               "z": torch.randn((2, 3), generator=g).to(torch.float16)}
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    ref = st.load_file(path)
    with safetensors_io.SafetensorsFile(path) as f:
        for name, t in tensors.items():
            assert torch.equal(ref[name], t) and torch.equal(
                f.read(name, CPU), t), name


def test_reader_refuses_bad_files(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"x": {"dtype": "I64", "shape": [2],
                               "data_offsets": [0, 16]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="I64"):
        safetensors_io.SafetensorsFile(str(path))
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 16]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="data_offsets"):
        safetensors_io.SafetensorsFile(str(path))
    with pytest.raises(FileNotFoundError):
        safetensors_io.Checkpoint(str(tmp_path / "nowhere"))


def test_checkpoint_reads_the_sharded_layout(checkpoints):
    path = checkpoints["sharded"]
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    assert len(files) == 2
    ref = {}
    for fname in files:
        ref.update(st.load_file(os.path.join(path, fname)))
    with safetensors_io.Checkpoint(path) as ckpt:
        assert ckpt.names == set(ref)
        for name, t in ref.items():
            assert torch.equal(ckpt.read(name, CPU), t), name


# -- config and loader --------------------------------------------------------


@pytest.mark.parametrize("name", ["llama_f32", "mistral", "rope_llama3",
                                  "tied"])
def test_read_hf_config_matches_reference(checkpoints, name):
    ref = jw.read_hf_config(checkpoints[name])
    cfg = tw.read_hf_config(checkpoints[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.dtype == "bfloat16"
    if name == "mistral":
        assert cfg.sliding_window == 4
    if name == "rope_llama3":
        assert cfg.rope_scaling == (8.0, 1.0, 4.0, 64.0)


def _edit_config(path, **fields):
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as fh:
        hf = json.load(fh)
    hf.update(fields)
    with open(cfg_path, "w") as fh:
        json.dump(hf, fh)


@pytest.mark.parametrize("fields,match", [
    (dict(rope_scaling={"rope_type": "yarn", "factor": 4.0}), "rope_scaling"),
    (dict(architectures=["GPT2LMHeadModel"]), "architecture"),
], ids=["rope_scheme", "architecture"])
def test_unsupported_checkpoints_raise_like_reference(tmp_path, fields,
                                                      match):
    path = _hf_model(tmp_path / "ck")
    _edit_config(path, **fields)
    with pytest.raises(ValueError, match=match):
        jw.load_hf_checkpoint(path)
    with pytest.raises(ValueError, match=match):
        tw.load_hf_checkpoint(path, "cpu")


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_loaded_tree_matches_reference(checkpoints, name):
    """Leaf for leaf, bit for bit: a bf16 checkpoint round-trips exactly,
    an f32 or f16 one rounds to bf16 to nearest even on both sides."""
    ref_cfg, ref = jw.load_hf_checkpoint(checkpoints[name])
    cfg, params = tw.load_hf_checkpoint(checkpoints[name], "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_leaves = dict(_leaves(ref))
    leaves = dict(_leaves(params))
    assert set(leaves) == set(ref_leaves)
    for key, t in leaves.items():
        assert t.dtype == torch.bfloat16 and t.is_contiguous(), key
        want = np.asarray(ref_leaves[key], np.float32)
        assert tuple(t.shape) == want.shape, key
        np.testing.assert_array_equal(t.float().numpy(), want, err_msg=key)
    if name == "tied":
        assert torch.equal(params["lm_head"], params["embed"].T)


def test_loader_refuses_a_tensor_of_the_wrong_shape(tmp_path):
    path = _hf_model(tmp_path / "ck")
    _edit_config(path, intermediate_size=96)
    with pytest.raises(ValueError, match="gate_proj"):
        tw.load_hf_checkpoint(path, "cpu")


def _float32(cfg, params):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if isinstance(params["embed"], torch.Tensor):
        return cfg, {k: ({n: t.float() for n, t in v.items()}
                         if isinstance(v, dict) else v.float())
                     for k, v in params.items()}
    return cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


@pytest.mark.parametrize("name", ["llama_bf16", "mistral", "rope_llama3"])
def test_forward_and_greedy_tokens_on_loaded_weights(checkpoints, name):
    """The loaded weights, widened to float32, give the reference's
    logits and greedy tokens (positions past the window and past
    original_max_position_embeddings are exercised)."""
    jcfg, jparams = _float32(*jw.load_hf_checkpoint(checkpoints[name]))
    tcfg, tparams = _float32(*tw.load_hf_checkpoint(checkpoints[name], "cpu"))
    tokens = (np.arange(96, dtype=np.int32)[None, :] * 7) % 128
    ref, _ = jl.forward(jparams, jcfg, tokens)
    out, _ = tl.forward(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    mesh = mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])
    jeng = JEngine(jcfg, JServing(mesh=MeshConfig(tensor=1)), mesh=mesh,
                   params=jparams)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu")
    prompts = [[1, 5, 9, 23], list(range(3, 40))]
    assert teng.generate(prompts, 12) == jeng.generate(prompts, 12)


# -- tokenizer ----------------------------------------------------------------


def _build_tiny_checkpoint(path):
    """scripts/make_tiny_hf_checkpoint.py: a Llama checkpoint and a
    trained byte-level BPE tokenizer.json."""
    spec = importlib.util.spec_from_file_location(
        "make_tiny_hf_checkpoint",
        os.path.join(REPO, "scripts", "make_tiny_hf_checkpoint.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(str(path))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny") / "ck"
    tok_path = _build_tiny_checkpoint(path)
    return str(path), tok_path


TEXTS = ["the quick brown fox jumps over the lazy dog",
         "héllo wörld — ünïcode ✓ 日本語", "", "answer briefly: 42"]


def test_hf_tokenizer_matches_reference(tiny_ckpt):
    _, tok_path = tiny_ckpt
    ref, tok = jtok.load_tokenizer(tok_path), ttok.load_tokenizer(tok_path)
    assert isinstance(tok, ttok.HFTokenizer)
    assert (tok.vocab_size, tok.pad_id, tok.bos_id, tok.eos_id) == (
        ref.vocab_size, ref.pad_id, ref.bos_id, ref.eos_id)
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == ref.decode(ids) == text
        # Streamed one id at a time: the same deltas, never a split rune.
        dec, ref_dec = tok.stream_decoder(), ref.stream_decoder()
        deltas = [dec.feed([i]) for i in ids] + [dec.flush()]
        assert deltas == [ref_dec.feed([i]) for i in ids] + [ref_dec.flush()]
        assert "".join(deltas) == text


def test_load_tokenizer_errors(tmp_path, tiny_ckpt, monkeypatch):
    """No quiet fallback to bytes: a missing file raises, and so does a
    file when the `tokenizers` package is absent (as on the card)."""
    assert isinstance(ttok.load_tokenizer(""), ttok.ByteTokenizer)
    with pytest.raises(FileNotFoundError, match="tokenizer_path"):
        ttok.load_tokenizer(str(tmp_path / "missing.json"))
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="`tokenizers` package"):
        ttok.load_tokenizer(tiny_ckpt[1])


# -- the HF-checkpoint sidecar ------------------------------------------------


async def _generate(target, prompts):
    async with grpc.aio.insecure_channel(target) as channel:
        gen = channel.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateResponse.FromString,
        )
        out = []
        for prompt in prompts:
            resp = await gen(serving_pb2.GenerateRequest(
                prompt=prompt, max_new_tokens=8, return_tokens=True))
            out.append((list(resp.token_ids), resp.text, resp.prompt_tokens,
                        resp.model_id))
        return out


async def test_hf_checkpoint_sidecar_matches_reference(tiny_ckpt):
    """Both sidecars started on the same checkpoint and tokenizer.json
    (`hf_checkpoint_path`, `tokenizer_path`) return the same greedy
    token ids and text."""
    path, tok_path = tiny_ckpt
    small = dict(max_batch_size=2, kv_cache_max_seq=128)
    from ggrmcp_tpu.core.config import BatchingConfig as JBatching
    from ggrmcp_tpu_torch.core.config import BatchingConfig

    jside = JSidecar(JServing(
        hf_checkpoint_path=path, tokenizer_path=tok_path,
        mesh=MeshConfig(tensor=1, data=0), batching=JBatching(**small)))
    tside = Sidecar(ServingConfig(
        hf_checkpoint_path=path, tokenizer_path=tok_path,
        batching=BatchingConfig(**small)), device="cpu")
    assert isinstance(tside.tokenizer, ttok.HFTokenizer)
    assert tside.generation.cfg == tw.read_hf_config(path)
    jport, tport = await jside.start(0), await tside.start(0)
    try:
        prompts = ["the quick brown fox", "hello world from the acme"]
        ref = await _generate(f"localhost:{jport}", prompts)
        out = await _generate(f"localhost:{tport}", prompts)
    finally:
        await tside.stop()
        await jside.stop()
    assert out == ref
    assert all(ids for ids, _, _, _ in out)


async def test_hf_checkpoint_int8_sidecar(checkpoints):
    """`quantize="int8"` on an HF checkpoint: the weights reach the
    engine dense and are quantized there, so the sidecar's leaves equal
    the port's `quantize` of the loaded tensors bit for bit (values and
    bf16 scales), and greedy Generate gives the tokens of an engine on
    those weights."""
    from ggrmcp_tpu_torch.core.config import BatchingConfig
    from ggrmcp_tpu_torch.ops import quant as tq

    path = checkpoints["llama_bf16"]
    _, dense = tw.load_hf_checkpoint(path, "cpu")
    want = tq.quantize_model(dense)
    side = Sidecar(ServingConfig(
        hf_checkpoint_path=path, quantize="int8",
        batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=128)),
        device="cpu")
    got = side.generation.params
    for key, leaf in _leaves(want):
        mine = dict(_leaves(got))[key]
        if isinstance(leaf, tq.QuantizedTensor):
            assert isinstance(mine, tq.QuantizedTensor), key
            assert mine.q.dtype == torch.int8, key
            assert mine.scale.dtype == torch.bfloat16, key
            assert torch.equal(mine.q, leaf.q), key
            assert torch.equal(mine.scale, leaf.scale), key
        else:
            assert torch.equal(mine, leaf), key
    port = await side.start(0)
    try:
        out = await _generate(f"localhost:{port}", ["a b c d e"])
    finally:
        await side.stop()
    cfg = tw.read_hf_config(path)
    ref, _ = GenerationEngine(cfg, params=want, device="cpu").generate(
        [[1] + [b + 3 for b in b"a b c d e"]], 8, eos_id=2)
    assert out[0][0] == ref[0]


def test_params_and_checkpoint_are_exclusive(tiny_ckpt):
    with pytest.raises(ValueError, match="not both"):
        Sidecar(ServingConfig(hf_checkpoint_path=tiny_ckpt[0]),
                params={}, device="cpu")
