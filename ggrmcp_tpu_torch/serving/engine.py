"""Engines on one device. Port of `ggrmcp_tpu/serving/engine.py`:
`GenerationEngine` (dense Llama prefill, decode and whole-request
generation; no mesh, LoRA, speculative decoding, PP/SP or int8) and
`EmbeddingEngine` (BERT embeddings).

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
    """Dense Llama generation on one device: prefill + decode + fused
    generate. `params` (this package's dict of tensors, e.g. from
    models/convert.py) or random weights drawn from `seed`."""

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
        if params is None:
            t0 = time.monotonic()
            params = llama_mod.init_params(cfg, self.device, seed)
            logger.info(
                "initialized %s on %s: %.1fM params in %.1fs", cfg.name,
                self.device, count_params(params) / 1e6,
                time.monotonic() - t0,
            )
        self.params = params

    # -- forwards -------------------------------------------------------

    def prefill_forward(self, params, tokens, cache):
        """Forward for a FRESH prefill (cache written from offset 0)."""
        return self.decode_forward(params, tokens, cache)

    def decode_forward(self, params, tokens, cache):
        """Forward for decode / extension steps (cache has history)."""
        return llama_mod.forward(params, self.cfg, tokens, cache)

    def make_cache(self, batch: int, max_len: int) -> llama_mod.KVCache:
        return llama_mod.KVCache.create(self.cfg, batch, max_len, self.device)

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
