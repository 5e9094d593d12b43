"""Engines on one device. Port of `ggrmcp_tpu/serving/engine.py`:
`GenerationEngine` (dense Llama prefill, decode and whole-request
generation, with int8 weights and the int8 KV cache; no mesh, LoRA,
speculative decoding or PP/SP) and `EmbeddingEngine` (BERT embeddings).

The reference compiles one program per shape bucket; PyTorch runs
eagerly, so the buckets here only bound the shapes the kernels see.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.models import bert as bert_mod
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models.common import count_params, param_bytes
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig, sample
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.engine")


def bucket_len(n: int, minimum: int = 32, maximum: int = 1 << 20) -> int:
    """Round up to a power of two within [minimum, maximum]."""
    return min(
        max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1))))), maximum
    )


def fit_request(
    prompt: list[int], max_new: int, limit: int
) -> tuple[list[int], int]:
    """Clamp (prompt, max_new) so prompt + generation + 1 fits in a
    `limit`-length KV cache: keep the prompt tail, then cap max_new."""
    if len(prompt) + max_new + 1 > limit:
        keep = max(1, limit - max_new - 1)
        prompt = prompt[-keep:]
        max_new = max(1, min(max_new, limit - len(prompt) - 1))
    return prompt, max_new


class GenerationEngine:
    """Llama generation on one device: prefill + decode + fused
    generate. `params` (this package's dict of tensors, e.g. from
    models/convert.py or serving/weights.py) or random weights drawn from
    `seed`.

    `serving.quantize="int8"` quantizes the weights here, IN PLACE: each
    dense leaf of the given dict is replaced by its QuantizedTensor as
    soon as it is done, so that it can be freed (the reference donates
    the dense tree for the same reason); pass a copy of a tree you want
    to keep dense. `serving.synthetic_weights` draws the int8 structure
    directly and never makes a dense weight. `serving.kv_cache_dtype=
    "int8"` gives every cache int8 K/V and pins attention to
    `attention_ref` (`use_flash` False), as the reference does."""

    def __init__(
        self,
        cfg: llama_mod.LlamaConfig,
        serving: Optional[ServingConfig] = None,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.serving = serving or ServingConfig()
        self.device = resolve_device(device)
        self.kv_dtype = self.serving.kv_cache_dtype
        # An int8 cache is read dequantized by attention_ref: handing the
        # kernel a bf16 copy of the cache would forfeit the int8 bytes.
        self.use_flash: Optional[bool] = False if self.kv_dtype else None
        if params is None and self.serving.synthetic_weights:
            params = self._synthetic_int8_init(seed)
        else:
            if params is None:
                t0 = time.monotonic()
                params = llama_mod.init_params(cfg, self.device, seed)
                logger.info(
                    "initialized %s on %s: %.1fM params in %.1fs", cfg.name,
                    self.device, count_params(params) / 1e6,
                    time.monotonic() - t0,
                )
            if self.serving.quantize:
                params = self._quantize_params(params)
        self.params = params

    def _synthetic_int8_init(self, seed: int):
        """The int8 weight structure drawn directly (int8 values in
        [-127, 127], small positive scales and dense leaves), never a
        dense weight: perf staging at the size of the int8 model. The
        generated text is meaningless."""
        if self.serving.quantize != "int8":  # config validation mirrors this
            raise ValueError("synthetic_weights requires quantize='int8'")
        t0 = time.monotonic()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        dtype, dev = self.cfg.torch_dtype, self.device
        shapes = llama_mod.param_shapes(self.cfg)
        axes = dict(quant.quantize_targets(shapes))

        def positive(shape):
            # 0.02 * |N(0, 1)| + 1e-3 in the leaf's dtype.
            t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            return t.abs_().mul_(0.02).add_(1e-3)

        def leaf(path, shape):
            if path not in axes:
                return positive(shape)
            scale_shape = list(shape)
            scale_shape[axes[path]] = 1
            q = torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8, device=dev)
            return quant.QuantizedTensor(q=q, scale=positive(scale_shape))

        params = {
            key: ({name: leaf((key, name), shape)
                   for name, shape in value.items()}
                  if isinstance(value, dict) else leaf((key,), value))
            for key, value in shapes.items()
        }
        logger.info(
            "synthetic int8 init %s: %.1f MB of weights in %.1fs",
            self.cfg.name, quant.quantized_nbytes(params) / 1e6,
            time.monotonic() - t0,
        )
        return params

    def _quantize_params(self, params):
        """Int8 weight-only quantization in place, one leaf at a time and
        each stacked leaf one layer slice at a time, into int8 and scale
        tensors allocated up front: the float32 copy and quotient stay one
        layer's size (a whole llama3-8b w_gate would need 7.5 GB of each).
        Per-channel scales reduce within a layer, so the result is bitwise
        that of `quant.quantize` on the whole leaf. Each dense leaf is
        replaced in `params` once done."""
        if self.serving.quantize != "int8":
            raise ValueError(
                f"unknown quantize mode {self.serving.quantize!r}"
            )
        before = quant.quantized_nbytes(params)
        for path, axis in quant.quantize_targets(params):
            parent = params if len(path) == 1 else params["layers"]
            parent[path[-1]] = _quantize_by_slice(parent[path[-1]], axis)
        logger.info(
            "quantized %s to int8: %.1f → %.1f MB of weights",
            self.cfg.name, before / 1e6, quant.quantized_nbytes(params) / 1e6,
        )
        return params

    # -- forwards -------------------------------------------------------

    def prefill_forward(self, params, tokens, cache):
        """Forward for a FRESH prefill (cache written from offset 0)."""
        return self.decode_forward(params, tokens, cache)

    def decode_forward(self, params, tokens, cache):
        """Forward for decode / extension steps (cache has history)."""
        return llama_mod.forward(params, self.cfg, tokens, cache,
                                 use_flash=self.use_flash)

    def make_cache(self, batch: int, max_len: int) -> llama_mod.KVCache:
        return llama_mod.KVCache.create(self.cfg, batch, max_len, self.device,
                                        self.kv_dtype)

    def weight_bytes(self) -> int:
        return param_bytes(self.params)

    # -- bodies ---------------------------------------------------------

    def _prefill_impl(self, params, tokens, true_len, cache):
        """tokens [B, S] right-padded, true_len [B] → (last-position
        logits [B, V], cache with length = true_len). Logits are
        computed for every position first, as the reference does."""
        logits, cache = self.prefill_forward(params, tokens, cache)
        idx = torch.clamp(true_len.long() - 1, min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        cache.length = true_len.to(torch.int32)
        return last, cache

    def _generate_impl(
        self, params, tokens, true_len, max_new: int,
        sampling: SamplingConfig, seed: int, eos_id: int,
    ):
        """Prefill + decode loop. Returns (out_tokens [B, max_new],
        out_len [B]) on the host."""
        b = tokens.shape[0]
        cache = self.make_cache(b, tokens.shape[1] + max_new)
        last, cache = self._prefill_impl(params, tokens, true_len, cache)
        cur = sample(last, seed, 0, sampling)
        done = cur == eos_id
        out = [cur]
        for i in range(max_new - 1):
            logits, cache = self.decode_forward(params, cur[:, None], cache)
            nxt = sample(logits[:, -1], seed, i + 1, sampling)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
            out.append(nxt)
            cur = nxt
        toks = torch.stack(out, dim=1).cpu().numpy()
        is_eos = toks == eos_id
        any_eos = is_eos.any(axis=1)
        first_eos = is_eos.argmax(axis=1)
        out_len = np.where(any_eos, first_eos + 1, max_new)
        return toks, out_len

    # -- public API -----------------------------------------------------

    def _pack_prompts(
        self, prompts: list[list[int]], max_new: int, limit: int
    ) -> tuple[np.ndarray, np.ndarray, int]:
        fitted = [fit_request(p, max_new, limit) for p in prompts]
        prompts = [p for p, _ in fitted]
        max_new = min(m for _, m in fitted)
        s = bucket_len(max(len(p) for p in prompts), maximum=limit)
        tokens = np.zeros((len(prompts), s), dtype=np.int32)
        true_len = np.zeros((len(prompts),), dtype=np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            true_len[i] = len(p)
        return tokens, true_len, max_new

    @staticmethod
    def _decode_outputs(
        out: np.ndarray, out_len: np.ndarray, eos_id: int
    ) -> tuple[list[list[int]], list[str]]:
        results, reasons = [], []
        for i in range(out.shape[0]):
            ids = out[i, : out_len[i]].tolist()
            if ids and ids[-1] == eos_id:
                ids = ids[:-1]
                reasons.append("stop")
            else:
                reasons.append("length")
            results.append(ids)
        return results, reasons

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 128,
        sampling: SamplingConfig = SamplingConfig(),
        eos_id: int = 2,
        seed: int = 0,
    ) -> tuple[list[list[int]], list[str]]:
        """Batch generation. Returns (token lists, finish reasons)."""
        tokens, true_len, max_new = self._pack_prompts(
            prompts, max_new_tokens, self.cfg.max_seq_len
        )
        out, out_len = self._generate_impl(
            self.params, self._tensor(tokens), self._tensor(true_len),
            max_new, sampling, seed, eos_id,
        )
        return self._decode_outputs(out, out_len, eos_id)

    def generate_stream(
        self,
        prompt: list[int],
        max_new_tokens: int = 128,
        sampling: SamplingConfig = SamplingConfig(),
        eos_id: int = 2,
        seed: int = 0,
    ) -> Iterator[int]:
        """Single-sequence streaming: yields token ids as sampled."""
        prompt, max_new_tokens = fit_request(
            prompt, max_new_tokens, self.cfg.max_seq_len
        )
        s = bucket_len(len(prompt), maximum=self.cfg.max_seq_len)
        tokens = np.zeros((1, s), dtype=np.int32)
        tokens[0, : len(prompt)] = prompt
        true_len = np.array([len(prompt)], dtype=np.int32)
        max_cache = bucket_len(
            len(prompt) + max_new_tokens + 1, maximum=self.cfg.max_seq_len
        )
        with torch.no_grad():
            cache = self.make_cache(1, max_cache)
            last, cache = self._prefill_impl(
                self.params, self._tensor(tokens), self._tensor(true_len),
                cache,
            )
            cur = sample(last, seed, 0, sampling)
        for i in range(max_new_tokens):
            tok = int(cur[0])
            if tok == eos_id:
                return
            yield tok
            if i == max_new_tokens - 1:
                return
            with torch.no_grad():
                logits, cache = self.decode_forward(
                    self.params, cur[:, None], cache
                )
                cur = sample(logits[:, -1], seed, i + 1, sampling)

    def model_info(self) -> dict:
        return _model_info(self, "llama")


def _quantize_by_slice(w: torch.Tensor, axis: int) -> quant.QuantizedTensor:
    """`quant.quantize(w, axis)` computed one leading-axis slice at a time
    for a stacked [L, K, N] leaf (a 2-D leaf in one piece)."""
    if w.dim() < 3:
        return quant.quantize(w, axis=axis)
    scale_shape = list(w.shape)
    scale_shape[axis] = 1
    out = quant.QuantizedTensor(
        q=torch.empty(w.shape, dtype=torch.int8, device=w.device),
        scale=torch.empty(scale_shape, dtype=w.dtype, device=w.device),
    )
    for i in range(w.shape[0]):
        part = quant.quantize(w[i], axis=axis)
        out.q[i] = part.q
        out.scale[i] = part.scale
        del part
    return out


def build_kernels(device: torch.device) -> None:
    """Nothing is compiled ahead in eager PyTorch; on a card this builds
    the attention kernel before traffic arrives."""
    if device.type == "cuda":
        from ggrmcp_tpu_torch.ops import _build

        _build.load("flash_attention")


class EmbeddingEngine:
    """BERT-family embeddings on one device: a seq-bucketed batch embed.
    `params` (this package's dict of tensors) or random weights drawn
    from `seed`.

    Rows are not bucketed, unlike the reference, which pads the batch to
    a power of two so that jit compiles few programs: eagerly, padding
    rows would only cost compute. So every row the kernel sees holds at
    least one real token."""

    MAX_CHUNK = 4096

    def __init__(
        self,
        cfg: bert_mod.BertConfig,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = bert_mod.init_params(cfg, self.device, seed)
            logger.info(
                "initialized %s on %s: %.1fM params", cfg.name, self.device,
                count_params(params) / 1e6,
            )
        self.params = params

    def weight_bytes(self) -> int:
        return param_bytes(self.params)

    def warmup(self) -> None:
        build_kernels(self.device)

    def embed(
        self,
        token_lists: list[list[int]],
        pooling: str = "mean",
        max_length: int = 0,
    ) -> np.ndarray:
        """Embed a batch of token lists → float32 [N, D], L2-normalized;
        batches beyond MAX_CHUNK rows run in chunks."""
        return np.concatenate([
            self._embed_chunk(
                token_lists[i: i + self.MAX_CHUNK], pooling, max_length
            )
            for i in range(0, len(token_lists), self.MAX_CHUNK)
        ], axis=0)

    @torch.no_grad()
    def _embed_chunk(
        self, token_lists: list[list[int]], pooling: str, max_length: int
    ) -> np.ndarray:
        limit = max_length or self.cfg.max_seq_len
        longest = min(max(len(t) for t in token_lists), limit)
        s = bucket_len(longest, maximum=self.cfg.max_seq_len)
        tokens = np.zeros((len(token_lists), s), dtype=np.int32)
        mask = np.zeros((len(token_lists), s), dtype=np.int32)
        for i, ids in enumerate(token_lists):
            ids = ids[:limit]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        out = bert_mod.embed(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(mask).to(self.device), pooling,
        )
        return out.cpu().numpy()

    def model_info(self) -> dict:
        return _model_info(self, "bert")


def _model_info(engine, family: str) -> dict:
    return {
        "model_id": engine.cfg.name,
        "family": family,
        "num_params_million": int(count_params(engine.params) / 1e6),
        "max_seq_len": engine.cfg.max_seq_len,
        "dtype": engine.cfg.dtype,
        "mesh": {},
        "num_devices": 1,
        "platform": engine.device.type,
    }
