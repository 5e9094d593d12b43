"""Engines. Port of `ggrmcp_tpu/serving/engine.py`: `GenerationEngine`
(dense Llama or sparse-MoE prefill, decode and whole-request
generation, with int8 weights, the int8 KV cache, the paged and ring
caches for the batcher, multi-LoRA adapters, boot-time or from a
registry through the adapter arena, and speculative decoding against a
draft model; on one device or over a mesh: the batch over data x fsdp,
tensor- and expert-parallel, sequence-parallel fresh prefill (ring /
Ulysses attention) and pipeline-parallel serving over `stage`) and
`EmbeddingEngine` (BERT embeddings, on one device or over a mesh).

The reference compiles one program per shape bucket; PyTorch runs
eagerly, so the buckets here only bound the shapes the kernels see.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.models import bert as bert_mod
from ggrmcp_tpu_torch.models import family_module
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models import moe as moe_mod
from ggrmcp_tpu_torch.models.common import FLOAT32_LEAVES
from ggrmcp_tpu_torch.models.common import count_params, param_bytes
from ggrmcp_tpu_torch.ops import lora as lora_ops
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops import ring_attention as ring_mod
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig, sample
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel import pipeline as pp_mod
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving import checkpoint
from ggrmcp_tpu_torch.serving.compile_watcher import watcher
from ggrmcp_tpu_torch.serving.memory_ledger import MemoryLedger
from ggrmcp_tpu_torch.utils import failpoints
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
    """Decoder generation on one device (a dense Llama or a sparse MoE,
    `fam` the family module): prefill + decode + fused generate.
    `params` (this package's dict of tensors, e.g. from models/convert.py
    or serving/weights.py) or random weights drawn from `seed`. A MoE
    forward takes `valid`, the real tokens: padding never competes for
    expert capacity. MoE refuses a speculative draft, LoRA and the paged
    cache, as the reference does.

    `serving.quantize="int8"` quantizes the weights here, IN PLACE: each
    dense leaf of the given dict is replaced by its QuantizedTensor as
    soon as it is done, so that it can be freed (the reference donates
    the dense tree for the same reason); pass a copy of a tree you want
    to keep dense. `serving.synthetic_weights` draws the int8 structure
    directly and never makes a dense weight. `serving.kv_cache_dtype=
    "int8"` gives every cache int8 K/V and pins attention to
    `attention_ref` (`use_flash` False), as the reference does.

    `serving.speculative_draft` builds the draft model: `draft_params`
    (this package's dict, e.g. a reference draft through
    models/convert.py) or random weights drawn from `seed + 1`, as the
    reference draws its draft from the next key. `serving.kv_ring` sets
    `ring_capacity`, the batcher caches' length.

    The mesh (`mesh`, or `serving.mesh` over `device`: that one card
    unless the config asks for several coordinates, then every card; the
    CPU repeated) places the weights by the
    family's `param_specs` and every cache by its cache specs; with one
    coordinate nothing is sharded and the forward is the one-device
    path. Weights are drawn or given whole, then sharded IN PLACE (each
    whole leaf of the given dict is replaced by its shards as soon as
    they exist), then quantized shard by shard to the bits of the whole
    leaf's quantization; params already sharded (the sharded loader's)
    are used as they are. A spec axis that does not divide its dim is
    counted in `spec_downgrades`: the KV-head case (tensor does not
    divide KVH) is served with replicated KV; any weight's raises
    (ROADMAP A18b). With data blocks (`data` x `fsdp` above 1) each
    block's rows run on its own coordinates and every cache is split by
    slot over the blocks (`_sharded_kv`).

    A `sequence` axis above 1 sends fresh prefills of at least
    `serving.sp_prefill_min_seq` tokens through ring or Ulysses attention
    (`serving.sp_prefill`); a `stage` axis above 1 shards the layer stack
    and every cache over stages and runs prefill and decode through the
    staged forward (parallel/pipeline.py), with the reference's
    refusals."""

    def __init__(
        self,
        cfg: llama_mod.LlamaConfig,
        serving: Optional[ServingConfig] = None,
        params=None,
        seed: int = 0,
        device: DeviceLike = None,
        draft_params=None,
        mesh: Optional[mesh_mod.Mesh] = None,
    ):
        self.cfg = cfg
        self.fam = family_module(cfg)
        self.serving = serving or ServingConfig()
        if self.serving.failpoints:
            # Armed at the serving plane's root, as the reference does:
            # every entry point built on an engine gets the schedule.
            failpoints.registry.arm_spec(self.serving.failpoints)
        if mesh is None:
            mesh = mesh_mod.serving_mesh(self.serving.mesh, device)
        self.mesh = mesh
        # The controller device: tokens, lengths, tables and logits.
        self.device = resolve_device(mesh.devices[0])
        # Sharding downgrades, counted once per (leaf, dim) site, as the
        # reference's mesh_spec_downgrades gauge.
        self.spec_downgrades = 0
        self._downgrades_seen: set = set()
        self._check_mesh()
        self.kv_dtype = self.serving.kv_cache_dtype
        # An int8 cache is read dequantized by attention_ref: handing the
        # kernel a bf16 copy of the cache would forfeit the int8 bytes.
        self.use_flash: Optional[bool] = False if self.kv_dtype else None
        self.ring_capacity = self._ring_capacity()
        specs = (pp_mod.param_specs_pp(cfg) if self.pp_serving
                 else self.fam.param_specs(cfg))
        if params is None and self.serving.synthetic_weights:
            params = self._shard_params(self._synthetic_int8_init(seed), cfg,
                                        specs)
        else:
            if params is None:
                t0 = time.monotonic()
                # One whole tree from one generator, then sharded: a
                # per-shard draw would not reproduce across meshes.
                params = self.fam.init_params(cfg, self.device, seed)
                logger.info(
                    "initialized %s on %s: %.1fM params in %.1fs", cfg.name,
                    self.device, count_params(params) / 1e6,
                    time.monotonic() - t0,
                )
            params = self._shard_params(params, cfg, specs)
            if self.serving.quantize:
                params = self._quantize_params(params)
        self.params = self._init_lora(params, seed)
        self._init_speculative(seed, draft_params)
        # The device-memory ledger: the batchers built over this engine
        # register their components into it, so one reconcile() covers
        # the stack. Off with serving.observability. LoRA factors are
        # their own component (`lora`), outside `weights`.
        self.ledger = MemoryLedger(self.mesh.distinct_devices(),
                                   self.serving.observability.enabled)
        self.ledger.register("weights", self._ledger_weights)
        if self.adapter_arena is not None:
            self.adapter_arena.register_ledger(self.ledger)
        elif self.lora_enabled:
            self.ledger.register("lora", self._ledger_lora)
        if self.draft_cfg is not None:
            self.ledger.register("draft_weights", lambda: self.draft_params)
        _watch_compiles(self.serving)

    # -- the mesh -------------------------------------------------------

    def _check_mesh(self) -> None:
        """What the port serves on a mesh of more than one coordinate:
        the batch over data x fsdp (every data block of a coordinate on
        one device, `mesh.check_data_placement`), tensor and expert axes
        (expert for the MoE family), sequence and stage, with the
        reference's refusals. Each refusal raises here, at
        construction. A weight dim an axis does not divide is placed
        replicated and counted (`_shard_params`)."""
        self._init_sp_prefill()
        self._init_pp_serving()
        if self.mesh.size == 1:
            return
        mesh_mod.check_data_placement(self.mesh)
        sizes = self.mesh.shape
        if sizes["expert"] > 1 and self.fam is not moe_mod:
            raise ValueError(
                f"serving.mesh.expert={sizes['expert']} needs a MoE model; "
                f"{self.cfg.name} has no experts to shard"
            )

    def _init_sp_prefill(self) -> None:
        """Sequence-parallel prefill: with a `sequence` axis above 1,
        fresh prefills of at least sp_prefill_min_seq tokens run their
        attention through ring (K/V rotation) or Ulysses (the all-to-all
        head re-shard) instead of the local path (`prefill_forward`).
        The int8 cache composes (the hook attends the round-tripped step
        K/V), a sliding window too; the ring cache does not."""
        self._sp_n = mesh_mod.axis_size(self.mesh, "sequence")
        mode = self.serving.sp_prefill
        if mode and self.serving.kv_ring and self._sp_n > 1:
            raise ValueError(
                "sp_prefill does not compose with kv_ring: ring-capacity "
                "caches break the fresh-prefill cache-sized-to-chunk "
                "contract (chunked admission serves long prompts instead)"
            )
        self.sp_prefill = mode if (self._sp_n > 1 and mode) else ""
        self.sp_min_seq = self.serving.sp_prefill_min_seq
        self._sp_attn = None
        # Calls of the sequence-parallel attention: one a layer (a tensor
        # shard a layer on a tensor axis) for each prefill that took it.
        self.sp_calls = 0
        if not self.sp_prefill:
            return
        if mode == "ulysses" and self.cfg.num_heads % self._sp_n != 0:
            raise ValueError(
                f"ulysses sp_prefill needs heads ({self.cfg.num_heads}) "
                f"divisible by the sequence axis ({self._sp_n})"
            )
        impl = (ring_mod.ring_attention if mode == "ring"
                else ring_mod.ulysses_attention)
        mesh = self.mesh

        def sp_attn(q, k, v, causal=True, window=None, coord=None):
            self.sp_calls += 1
            return impl(q, k, v, mesh, causal=causal, window=window,
                        coord=coord)

        self._sp_attn = sp_attn

    def _init_pp_serving(self) -> None:
        """Pipeline-parallel serving: with a `stage` axis above 1,
        prefill and decode run the staged cached forward
        (parallel/pipeline.py) with the layer stack and the KV cache
        sharded over `stage`. Dense Llama only."""
        self._pp_n = mesh_mod.axis_size(self.mesh, "stage")
        self.pp_serving = self._pp_n > 1 and self.fam is llama_mod
        if self._pp_n > 1 and self.fam is not llama_mod:
            raise ValueError(
                "pipeline-parallel serving supports dense Llama only "
                "(MoE expert dispatch is batch-global per layer block)"
            )
        if self.pp_serving and self.cfg.num_layers % self._pp_n != 0:
            raise ValueError(
                f"{self.cfg.num_layers} layers not divisible by "
                f"stage={self._pp_n}"
            )
        if self.pp_serving and (self.serving.lora.adapters
                                or self.serving.lora.registry):
            raise ValueError(
                "lora does not compose with pipeline-parallel serving "
                "yet (the staged layer loop would need per-stage idx "
                "threading)"
            )
        if self.pp_serving and self.sp_prefill:
            # One manual-collective scheme at a time: the staged forward
            # owns the layer loop.
            logger.warning("sp_prefill disabled under pipeline serving")
            self.sp_prefill = ""
            self._sp_attn = None

    def _note_downgrade(self, where: str, dim: int, entry, size: int,
                        axis: int) -> None:
        """compatible_spec dropped a real sharding axis for `where`:
        count it once per (leaf, dim) site and log it."""
        key = (where, dim)
        if key not in self._downgrades_seen:
            self._downgrades_seen.add(key)
            self.spec_downgrades += 1
            logger.warning(
                "mesh spec downgrade: %s dim %d (size %d) not divisible "
                "by mesh axis %r (size %d); replicated instead of sharded "
                "(mesh_spec_downgrades)", where or "<leaf>", dim, size,
                entry, axis,
            )

    def _shard_params(self, params, cfg, specs):
        """Place a whole tree on the mesh by `specs`, IN PLACE
        (`llama.shard_params`; a no-op on one coordinate, and for leaves
        already sharded). A weight dim the mesh does not divide is
        replicated and counted, and its block held whole on every
        tensor shard (`llama.whole_blocks`)."""
        mesh = self.mesh
        if mesh.size == 1:
            return params
        params = llama_mod.shard_params(params, cfg, mesh, specs,
                                        on_downgrade=self._note_downgrade)
        logger.info("sharded %s over %s (whole on every tensor shard: %s)",
                    cfg.name, mesh_mod.mesh_shape_str(mesh),
                    sorted(llama_mod.whole_blocks(
                        cfg, mesh.shape["tensor"])) or "none")
        return params

    def mesh_stats(self) -> dict:
        """Mesh identity for ServingStats: tensor shards, mesh
        coordinates, the shape label and the sharding downgrades (0 =
        every spec landed as written)."""
        return {
            "tp_chips": mesh_mod.axis_size(self.mesh, "tensor"),
            "mesh_devices": self.mesh.size,
            "mesh_shape": mesh_mod.mesh_shape_str(self.mesh),
            "mesh_spec_downgrades": self.spec_downgrades,
        }

    def _sharded_kv(self, cfg, create, shape, spec, site: Optional[str]):
        """A cache whose K/V leaves are split over tensor by `spec` (KV
        heads, dim 3 of `shape`), over stage when the spec names it
        (layers, dim 0), and by slot over the data blocks when the data
        product divides the batch (dim 1). A block is keyed by (data
        block, tensor block, stage, device): `create(local_cfg, device)`
        builds one whole-batch storage per (tensor block, stage, device)
        and each data block's part is the view of its rows in it, so
        the batcher's row moves, which index slots globally, reach every
        block (`Sharded.bases`; `mesh.check_data_placement` keeps a
        coordinate's data blocks on one device). Coordinates that differ
        only in their expert or sequence index share a block's storage.
        The KV heads are replicated when tensor does not divide them, a
        batch the data blocks do not divide is kept whole in every part,
        and each such downgrade is counted at `site` (the reference's
        `_observe_cache_spec`; None counts nothing). Lengths and tables stay on the controller
        device."""
        mesh = self.mesh

        adapted = mesh_mod.compatible_spec(
            spec, shape, mesh,
            on_downgrade=None if site is None else (
                lambda dim, entry, size, axis: self._note_downgrade(
                    site, dim, entry, size, axis)))
        t = mesh.shape["tensor"]
        # A whole attention block computes every KV head on every shard.
        if "attn" in llama_mod.whole_blocks(cfg, t):
            t = 1
        split = adapted[3] is not None and t > 1
        # A staged cache: each stage's coordinates hold its layers.
        stages = mesh_mod.axis_product(mesh, adapted[0])
        data = mesh_mod.axis_product(mesh, adapted[1])
        per = shape[1] // data
        lcfg = llama_mod.local_config(cfg, t)
        lcfg = dataclasses.replace(lcfg,
                                   num_layers=cfg.num_layers // stages)
        built: dict = {}
        locals_, blocks = [], []
        for c, dev in enumerate(mesh.devices):
            coord = mesh.coord(c)
            key = (coord["tensor"] if split else 0,
                   coord["stage"] if stages > 1 else 0, dev)
            if key not in built:
                built[key] = create(lcfg, dev)
            locals_.append(built[key])
            blocks.append(mesh_mod.data_block(mesh, c) if data > 1 else 0)
        factors = (stages, data, 1, t if split else 1, 1)

        def sharded(parts):
            if data == 1:
                return Sharded(tuple(parts), factors, mesh)
            views: dict = {}
            rows = []
            for p, blk in zip(parts, blocks):
                rows.append(views.setdefault(
                    (id(p), blk), p[:, blk * per:(blk + 1) * per]))
            return Sharded(tuple(rows), factors, mesh, bases=tuple(parts),
                           batch_dim=1 - len(shape))

        def leaf(name):
            parts = [getattr(lc, name) for lc in locals_]
            if isinstance(parts[0], quant.QuantizedTensor):
                return quant.QuantizedTensor(
                    q=sharded([p.q for p in parts]),
                    scale=sharded([p.scale for p in parts]))
            return sharded(parts)

        # The lengths (and a paged cache's block tables) on the
        # controller: a zero-layer cache of the same geometry.
        base = create(dataclasses.replace(cfg, num_layers=0), self.device)
        base.k, base.v = leaf("k"), leaf("v")
        return base

    def _ring_capacity(self) -> Optional[int]:
        """Ring-buffer KV (serving.kv_ring, sliding-window models): the
        batcher's caches hold window + prefill_chunk - 1 positions, the
        clobber bound of a chunked step; None without the ring."""
        if not self.serving.kv_ring:
            return None
        window = self.cfg.sliding_window
        if not window:
            raise ValueError(
                f"kv_ring requires a sliding-window model; {self.cfg.name} "
                f"has none"
            )
        chunk = self.serving.batching.prefill_chunk
        cap = window + chunk - 1
        if cap > self.cfg.max_seq_len:
            # Clamping instead would break the clobber bound the model
            # layer asserts (C >= W + chunk - 1).
            raise ValueError(
                f"kv_ring: sliding_window ({window}) + prefill_chunk "
                f"({chunk}) - 1 = {cap} exceeds max_seq_len "
                f"({self.cfg.max_seq_len}); lower batching.prefill_chunk"
            )
        return cap

    # -- speculative decoding -------------------------------------------

    def _init_speculative(self, seed: int, draft_params) -> None:
        """The draft model of serving.speculative_draft (None = off),
        with the reference's rejections: the target must be dense and the
        draft a dense llama sharing its vocabulary. It serves the
        whole-generation micro-path (generate_speculative) and the
        batcher's spec tick (batching.speculative)."""
        self.draft_cfg: Optional[llama_mod.LlamaConfig] = None
        self.draft_params = None
        name = self.serving.speculative_draft
        if not name:
            if draft_params is not None:
                raise ValueError("draft_params given without "
                                 "serving.speculative_draft")
            return
        if self.pp_serving:
            raise ValueError(
                "speculative decoding is not supported under "
                "pipeline-parallel serving (the draft/verify loop would "
                "run the layer scan against stage-sharded weights)"
            )
        if self.fam is moe_mod:
            raise ValueError(
                "speculative decoding supports dense decoder targets "
                "only (MoE routing is batch-global, which breaks the "
                "lossless verification guarantee)"
            )
        from ggrmcp_tpu_torch.models import get_model

        family, dcfg = get_model(name)
        if family != "llama":
            raise ValueError("speculative draft must be a dense decoder model")
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}"
            )
        path = self.serving.speculative_draft_checkpoint
        if draft_params is None and path:
            draft_params = checkpoint.load_params(
                path, self.device, name, llama_mod.param_shapes(dcfg),
                "serving.speculative_draft_checkpoint")
        elif draft_params is None:
            draft_params = llama_mod.init_params(dcfg, self.device, seed + 1)
        self.draft_cfg = dcfg
        # The draft shares the mesh, sharded by the dense family's specs.
        self.draft_params = self._shard_params(
            draft_params, dcfg, llama_mod.param_specs(dcfg))

    def draft_forward(self, params, tokens, cache):
        """Forward of the draft model (the batcher's spec tick and
        generate_speculative), under the engine's flash policy."""
        return llama_mod.forward(params, self.draft_cfg, tokens, cache,
                                 use_flash=self.use_flash)

    @property
    def verify_flash(self) -> Optional[bool]:
        """The flash policy of the (gamma+1)-position verify: the kernel
        (at gamma 4 the query is 5 wide, under the dispatcher's threshold
        for B1, where `attention_ref` would cast the whole cache to
        float32 in every layer), unless the int8 cache pins
        `attention_ref`."""
        return False if self.use_flash is False else True

    def verify_forward(self, params, tokens, cache):
        """Target forward of a speculative verify window."""
        return llama_mod.forward(params, self.cfg, tokens, cache,
                                 use_flash=self.verify_flash)

    def make_draft_cache(self, batch: int, max_len: int,
                         site: Optional[str] = "kv_cache"
                         ) -> llama_mod.KVCache:
        """The batcher's draft slot-pool cache, in the engine's KV dtype,
        sharded like the target's (`site` as `make_cache`'s)."""
        return self.make_cache(batch, max_len, cfg=self.draft_cfg, site=site)

    @torch.no_grad()
    def generate_speculative(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 128,
        eos_id: int = 2,
        temperatures: Optional[list[float]] = None,
        seeds: Optional[list[int]] = None,
    ) -> tuple[list[list[int]], list[str], dict]:
        """Speculative batch generation (needs the draft). With
        `temperatures=None` the tokens are greedy `generate`'s; a per-row
        list samples rows > 0 by rejection (distributed as plain
        sampling). Returns (token lists, finish reasons, stats with the
        acceptance rate). The decode budget is bucketed like the
        reference's, the requested cap applied inside it."""
        if self.draft_cfg is None:
            raise RuntimeError("speculative decoding not configured")
        from ggrmcp_tpu_torch.ops.speculative import speculative_generate

        limit = min(self.cfg.max_seq_len, self.draft_cfg.max_seq_len)
        tokens, true_len, max_new_tokens = self._pack_prompts(
            prompts, max_new_tokens, limit
        )
        budget = bucket_len(max_new_tokens, minimum=8, maximum=limit)
        temps = seed_arr = None
        if temperatures is not None:
            temps = self._tensor(np.asarray(temperatures, np.float32))
            if not seeds:
                # Distinct per-row defaults: a shared seed would make the
                # rows of a sampled batch draw one stream.
                seeds = list(range(len(prompts)))
            seed_arr = self._tensor(np.asarray(
                [(s or 0) & 0xFFFFFFFF for s in seeds], np.int64))
        res = speculative_generate(
            self.params, self.cfg, self.draft_params, self.draft_cfg,
            self._tensor(tokens), self._tensor(true_len), budget,
            self.serving.speculative_gamma, eos_id, max_new=max_new_tokens,
            use_flash=self.use_flash, verify_flash=self.verify_flash,
            temperature=temps, seeds=seed_arr,
            make_cache=self.make_cache, make_draft_cache=self.make_draft_cache,
        )
        results, reasons = self._decode_outputs(
            res.tokens.cpu().numpy(), res.out_len.cpu().numpy(), eos_id
        )
        stats = {
            "rounds": res.rounds,
            "drafted": res.drafted,
            "accepted": res.accepted,
            "acceptance_rate": (
                round(res.accepted / res.drafted, 4) if res.drafted else 0.0
            ),
        }
        return results, reasons, stats

    def _ledger_weights(self):
        """Model parameters without the LoRA factors."""
        params = self.params
        if self.lora_enabled:
            params = {
                **params,
                "layers": {
                    k: v for k, v in params["layers"].items()
                    if not k.startswith("lora_")
                },
            }
        return params

    def _ledger_lora(self):
        """The boot-time factor stacks inside params."""
        return {
            k: v for k, v in self.params["layers"].items()
            if k.startswith("lora_")
        }

    # -- LoRA -----------------------------------------------------------

    def _init_lora(self, params, seed: int):
        """Multi-LoRA serving (ops/lora.py): the factor stacks go into
        params["layers"] after quantization (they stay in the model
        dtype). Row 0 is the base no-op adapter. Two modes, as in the
        reference (core/config.py LoraConfig): boot-time `adapters`,
        rows fixed at init and resolved by `resolve_adapter`; or a
        `registry` served through the adapter arena, resolved per
        request by `AdapterArena.acquire`."""
        self.lora_names: dict[str, int] = {}
        self.adapter_arena = None
        lcfg = self.serving.lora
        adapters = list(lcfg.adapters)
        self.lora_enabled = bool(adapters) or bool(lcfg.registry)
        if not self.lora_enabled:
            return params
        if adapters and lcfg.registry:
            raise ValueError(
                "lora.registry and lora.adapters are mutually exclusive"
            )
        if self.fam is not llama_mod:
            raise ValueError("lora serving supports dense Llama only")
        if self.serving.speculative_draft or (
                self.serving.batching.speculative == "on"):
            raise ValueError(
                "lora does not compose with speculative decoding (the "
                "draft/verify loop runs the base model; an adapter'd "
                "request would silently lose its adapter)"
            )
        if lcfg.rank < 1:
            raise ValueError("lora.rank must be >= 1")
        if lcfg.registry:
            from ggrmcp_tpu_torch.serving.adapter_arena import AdapterArena

            # params holds the arena's own tensors; a load writes a row
            # of them in place, so every later forward serves it (the
            # reference reinstalls new arrays after each load instead).
            self.adapter_arena = AdapterArena(
                lcfg.registry, int(lcfg.arena_rows), lcfg.rank, self.cfg,
                device=self.device, mesh=self.mesh,
            )
            params["layers"] = {
                **params["layers"],
                "lora_qkv_a": self.adapter_arena.a_dev,
                "lora_qkv_b": self.adapter_arena.b_dev,
            }
            logger.info(
                "lora arena: %d device rows over registry %s (rank %d, "
                "%d adapter(s) registered, %.1f MB resident)",
                self.adapter_arena.rows, lcfg.registry, lcfg.rank,
                len(self.adapter_arena.registered()),
                (self.adapter_arena.a_dev.nbytes
                 + self.adapter_arena.b_dev.nbytes) / 1e6,
            )
            return params
        if len(set(adapters)) != len(adapters) or "" in adapters:
            raise ValueError("lora.adapters must be unique, non-empty names")
        for name in adapters:
            # Names become `{lora.path}/{name}.npz`.
            if "/" in name or "\\" in name or name.startswith("."):
                raise ValueError(
                    f"lora adapter name {name!r} must be a plain name "
                    f"(no path separators or leading dots)"
                )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed + 7)
        factors = llama_mod.shard_lora(lora_ops.init_lora_layers(
            self.cfg, len(adapters), lcfg.rank, gen, self.device), self.cfg,
            self.mesh)
        params["layers"] = {**params["layers"], **factors}
        self.lora_names = {name: i + 1 for i, name in enumerate(adapters)}
        logger.info(
            "lora serving: %d adapter(s) %s, rank %d (%.1f MB of factors)",
            len(adapters), adapters, lcfg.rank,
            sum(v.nbytes for v in factors.values()) / 1e6,
        )
        if lcfg.path:
            self.params = params  # set_lora_weights writes through it
            self._load_lora_dir(lcfg.path)
        return params

    def _load_lora_dir(self, path: str) -> None:
        """Trained factors from `{path}/{name}.npz` (arrays `a`, `b`):
        a missing file leaves that adapter a no-op; a present but wrong
        file fails loudly."""
        import os

        for name in self.lora_names:
            f = os.path.join(path, f"{name}.npz")
            if not os.path.exists(f):
                logger.info("lora: no factors at %s (adapter stays no-op)", f)
                continue
            with np.load(f) as data:
                try:
                    self.set_lora_weights(name, data["a"], data["b"])
                except (KeyError, ValueError) as exc:
                    raise ValueError(f"lora factors {f}: {exc}") from exc
            logger.info("lora: loaded %s", f)

    def n_adapter_rows(self) -> int:
        """Highest valid per-request adapter row id (0 = base)."""
        if self.adapter_arena is not None:
            return self.adapter_arena.rows
        return len(self.lora_names)

    def resolve_adapter(self, name: str) -> int:
        """Adapter name → served row id (0 = base; raises on unknown).
        Boot-time mode only: the arena resolves names through the
        batcher's serialized acquire stream."""
        if not name:
            return 0
        if self.adapter_arena is not None:
            raise ValueError(
                "dynamic adapter arena: resolve adapter names via "
                "AdapterArena.acquire (batcher.acquire_adapter on "
                "serving paths), not resolve_adapter"
            )
        try:
            return self.lora_names[name]
        except KeyError:
            raise ValueError(
                f"unknown adapter {name!r}; configured: "
                f"{sorted(self.lora_names)}"
            ) from None

    def set_lora_weights(self, name: str, a, b) -> None:
        """Install trained factors for a boot-time adapter: a [L, D, r],
        b [L, r, (H+2KVH)*Dh] (pre-scaled by alpha/r), written into its
        row in place. Row 0 (base) cannot be written."""
        idx = self.resolve_adapter(name)
        if idx == 0:
            raise ValueError("cannot overwrite the base adapter row")
        layers = self.params["layers"]
        dtype = self.cfg.torch_dtype
        a = torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
        b = torch.as_tensor(np.asarray(b, np.float32)).to(dtype)
        # Explicit shape checks: an assignment broadcasts, so a single
        # layer's [D, r] would install identical factors in every layer.
        want_a = tuple(layers["lora_qkv_a"].shape[0:1]
                       + layers["lora_qkv_a"].shape[2:])
        want_b = tuple(layers["lora_qkv_b"].shape[0:1]
                       + layers["lora_qkv_b"].shape[2:])
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise ValueError(
                f"factor shapes {tuple(a.shape)}/{tuple(b.shape)} != "
                f"expected {want_a}/{want_b}"
            )
        for name, value in (("lora_qkv_a", a), ("lora_qkv_b", b)):
            llama_mod.set_lora_row(layers[name], idx, value, self.cfg)

    def lora_stats(self) -> dict:
        """ServingStats lora_* scalars: the arena's live counters; the
        boot-time set is both registered and resident; all zero with
        LoRA off."""
        if self.adapter_arena is not None:
            return self.adapter_arena.stats()
        n = len(self.lora_names)
        return {
            "lora_adapters_registered": n,
            "lora_adapters_resident": n,
            "lora_rows_total": n,
            "lora_loads": 0,
            "lora_evictions": 0,
            "lora_hits": 0,
            "lora_load_ms": 0.0,
            "lora_shed": 0,
        }

    def adapter_rows(self, names) -> tuple[list[int], list]:
        """Per-prompt adapter names (or row ids) → (rows, arena leases
        to release when done): ids are range-checked, names resolve
        through the arena (pinned) or the boot-time table."""
        rows, leases = [], []
        try:
            for name in names:
                if isinstance(name, int):
                    if not 0 <= name <= self.n_adapter_rows():
                        raise ValueError(
                            f"adapter id {name} out of range "
                            f"(0..{self.n_adapter_rows()})"
                        )
                    rows.append(name)
                elif self.adapter_arena is not None:
                    lease = self.adapter_arena.acquire(name or "")
                    leases.append(lease)
                    rows.append(lease.row)
                else:
                    rows.append(self.resolve_adapter(name or ""))
        except Exception:
            self._release_leases(leases)
            raise
        return rows, leases

    def _release_leases(self, leases) -> None:
        for lease in leases:
            self.adapter_arena.release(lease)

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
        shapes = self.fam.param_shapes(self.cfg)
        axes = dict(quant.quantize_targets(shapes))

        def positive(shape, leaf_dtype=dtype):
            # 0.02 * |N(0, 1)| + 1e-3 in the leaf's dtype.
            t = torch.randn(shape, generator=gen, dtype=leaf_dtype,
                            device=dev)
            return t.abs_().mul_(0.02).add_(1e-3)

        def leaf(path, shape):
            if path[-1] in FLOAT32_LEAVES:
                return positive(shape, torch.float32)
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
            leaf = parent[path[-1]]
            parent[path[-1]] = (
                quant.quantize_sharded(leaf, axis, _quantize_by_slice)
                if isinstance(leaf, Sharded)
                else _quantize_by_slice(leaf, axis))
        logger.info(
            "quantized %s to int8: %.1f → %.1f MB of weights",
            self.cfg.name, before / 1e6, quant.quantized_nbytes(params) / 1e6,
        )
        if any(d.type == "cuda" for d in self.mesh.distinct_devices()):
            # The dense leaves this engine drew are free now: hand their
            # blocks back to the card (other processes share it), not
            # to this process's allocator cache.
            torch.cuda.empty_cache()
        return params

    # -- forwards -------------------------------------------------------

    def prefill_forward(self, params, tokens, cache, lora_idx=None,
                        valid=None):
        """Forward for a FRESH prefill (cache written from offset 0, sized
        to the step: the batcher's admission mini caches and the
        engine's own). The staged forward under PP; the sequence-parallel
        attention for a dense Llama prompt of at least sp_prefill_min_seq
        tokens that the sequence axis divides; else `decode_forward`."""
        if self.pp_serving:
            return pp_mod.pipeline_forward_cached(params, self.cfg, tokens,
                                                  cache, self.mesh)
        s = tokens.shape[1]
        if (self._sp_attn is not None and self.fam is llama_mod
                and s >= self.sp_min_seq and s % self._sp_n == 0):
            return llama_mod.forward(params, self.cfg, tokens, cache,
                                     attn_impl=self._sp_attn,
                                     lora_idx=lora_idx)
        return self.decode_forward(params, tokens, cache, lora_idx,
                                   valid=valid)

    def decode_forward(self, params, tokens, cache, lora_idx=None,
                       ring: bool = False, valid=None):
        """Forward for decode / extension steps (cache has history): a
        contiguous KVCache or a PagedKVCache. `lora_idx`: [B] adapter
        rows (None = every row base). `ring` describes the CACHE (the
        batcher's ring-capacity caches), not the engine: the engine's
        own request-sized caches stay contiguous. `valid` [B, S]: the
        real tokens, for MoE routing (the dense family ignores it). The
        staged forward under PP."""
        if self.pp_serving:
            return pp_mod.pipeline_forward_cached(params, self.cfg, tokens,
                                                  cache, self.mesh,
                                                  ring=ring)
        if self.fam is moe_mod:
            return moe_mod.forward(params, self.cfg, tokens, cache,
                                   valid=valid, use_flash=self.use_flash,
                                   ring=ring)
        return llama_mod.forward(params, self.cfg, tokens, cache,
                                 use_flash=self.use_flash,
                                 lora_idx=lora_idx, ring=ring)

    def make_cache(self, batch: int, max_len: int, cfg=None,
                   site: Optional[str] = "kv_cache") -> llama_mod.KVCache:
        """A contiguous cache of `cfg`'s geometry (default the target's),
        on the mesh: KV heads over tensor by `cache_specs`. `site` names
        where a spec downgrade is counted; None for an admission's mini
        cache, which the reference builds inside its jitted prefill,
        where no downgrade is observed."""
        other = cfg is not None
        cfg = cfg or self.cfg
        if self.mesh.size == 1:
            return llama_mod.KVCache.create(cfg, batch, max_len, self.device,
                                            self.kv_dtype)
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        specs = (pp_mod.cache_specs_pp() if self.pp_serving and not other
                 else llama_mod.cache_specs())
        return self._sharded_kv(
            cfg, lambda lcfg, dev: llama_mod.KVCache.create(
                lcfg, batch, max_len, dev, self.kv_dtype),
            shape, specs["k"], site)

    def make_paged_cache(
        self, batch: int, max_len: int, n_pages: int, page_size: int
    ) -> llama_mod.PagedKVCache:
        """A page arena of `n_pages` pages (plus the scratch page) with
        all-sentinel block tables, in the engine's KV dtype. Dense Llama
        only, as in the reference; not under PP."""
        if self.pp_serving:
            raise ValueError(
                "paged_kv does not compose with pipeline-parallel "
                "serving (the staged forward has no block-table path)"
            )
        if self.fam is not llama_mod:
            raise ValueError("paged_kv supports dense Llama only")
        if self.mesh.size == 1:
            return llama_mod.PagedKVCache.create(
                self.cfg, batch, max_len, n_pages, page_size, self.device,
                self.kv_dtype,
            )
        cfg = self.cfg
        shape = (cfg.num_layers, n_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return self._sharded_kv(
            cfg, lambda lcfg, dev: llama_mod.PagedKVCache.create(
                lcfg, batch, max_len, n_pages, page_size, dev, self.kv_dtype),
            shape, llama_mod.paged_cache_specs()["k"], "paged_kv_arena")

    def weight_bytes(self) -> int:
        return param_bytes(self.params)

    # -- bodies ---------------------------------------------------------

    def _prefill_impl(self, params, tokens, true_len, cache, lora_idx=None):
        """tokens [B, S] right-padded, true_len [B] → (last-position
        logits [B, V], cache with length = true_len). Logits are
        computed for every position first, as the reference does.
        Padding is not `valid`: it must not take MoE expert capacity."""
        valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                 < true_len[:, None])
        logits, cache = self.prefill_forward(params, tokens, cache, lora_idx,
                                             valid)
        idx = torch.clamp(true_len.long() - 1, min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        cache.length = true_len.to(torch.int32)
        return last, cache

    def _generate_impl(
        self, params, tokens, true_len, max_new: int,
        sampling: SamplingConfig, seed: int, eos_id: int, lora_idx=None,
    ):
        """Prefill + decode loop. Returns (out_tokens [B, max_new],
        out_len [B]) on the host."""
        b = tokens.shape[0]
        cache = self.make_cache(b, tokens.shape[1] + max_new)
        last, cache = self._prefill_impl(params, tokens, true_len, cache,
                                         lora_idx)
        cur = sample(last, seed, 0, sampling)
        done = cur == eos_id
        out = [cur]
        for i in range(max_new - 1):
            logits, cache = self.decode_forward(params, cur[:, None], cache,
                                                lora_idx)
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
        adapters: Optional[list] = None,
    ) -> tuple[list[list[int]], list[str]]:
        """Batch generation. Returns (token lists, finish reasons).
        `adapters`: per-prompt LoRA adapter names (or row ids); None or
        "" rows ride the base model (arena rows stay pinned for the
        call)."""
        tokens, true_len, max_new = self._pack_prompts(
            prompts, max_new_tokens, self.cfg.max_seq_len
        )
        if adapters and len(adapters) > len(prompts):
            raise ValueError(
                f"{len(adapters)} adapters for {len(prompts)} prompts"
            )
        rows, leases = self.adapter_rows(adapters or [])
        idx = np.zeros((tokens.shape[0],), np.int64)
        idx[: len(rows)] = rows
        try:
            out, out_len = self._generate_impl(
                self.params, self._tensor(tokens), self._tensor(true_len),
                max_new, sampling, seed, eos_id,
                self._tensor(idx) if self.lora_enabled else None,
            )
        finally:
            self._release_leases(leases)
        return self._decode_outputs(out, out_len, eos_id)

    def generate_stream(
        self,
        prompt: list[int],
        max_new_tokens: int = 128,
        sampling: SamplingConfig = SamplingConfig(),
        eos_id: int = 2,
        seed: int = 0,
        adapter: str = "",
    ) -> Iterator[int]:
        """Single-sequence streaming: yields token ids as sampled.
        `adapter`: LoRA adapter name ("" = base; an arena row stays
        pinned for the stream's life)."""
        rows, leases = self.adapter_rows([adapter])
        try:
            yield from self._stream(prompt, max_new_tokens, sampling, eos_id,
                                    seed, rows[0])
        finally:
            self._release_leases(leases)

    def _stream(self, prompt, max_new_tokens, sampling, eos_id, seed,
                row: int) -> Iterator[int]:
        lora_idx = (
            self._tensor(np.array([row], np.int64)) if self.lora_enabled
            else None
        )
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
                cache, lora_idx,
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
                    self.params, cur[:, None], cache, lora_idx
                )
                cur = sample(logits[:, -1], seed, i + 1, sampling)

    def model_info(self) -> dict:
        return _model_info(self, "moe" if self.fam is moe_mod else "llama")


def _quantize_by_slice(w: torch.Tensor, axis: int,
                       amax: Optional[torch.Tensor] = None
                       ) -> quant.QuantizedTensor:
    """`quant.quantize_with(w, axis, amax)` computed one leading-axis
    slice at a time for a stacked [L, K, N] leaf (a 2-D leaf in one
    piece). `amax`: the per-channel max of a sharded leaf, or None."""
    if w.dim() < 3:
        return quant.quantize_with(w, axis, amax)
    scale_shape = list(w.shape)
    scale_shape[axis] = 1
    out = quant.QuantizedTensor(
        q=torch.empty(w.shape, dtype=torch.int8, device=w.device),
        scale=torch.empty(scale_shape, dtype=w.dtype, device=w.device),
    )
    for i in range(w.shape[0]):
        part = quant.quantize_with(w[i], axis,
                                   None if amax is None else amax[i])
        out.q[i] = part.q
        out.scale[i] = part.scale
        del part
    return out


def _watch_compiles(serving: ServingConfig) -> None:
    """With serving.observability on, the compile watcher counts kernel
    builds and loads; a fresh engine opens a new warmup era (its cold
    compiles are expected; the sidecar marks warm after its warmup)."""
    if serving.observability.enabled:
        watcher.install()
        watcher.mark_cold()


def build_kernels(device: torch.device) -> None:
    """Eager PyTorch traces no program ahead; on a card this builds (or
    loads from `build/kernels/`) the attention kernel's library before
    traffic arrives, a compile the watcher counts."""
    if device.type == "cuda":
        from ggrmcp_tpu_torch.ops import _build

        _build.load("flash_attention")


class EmbeddingEngine:
    """BERT-family embeddings: a seq-bucketed batch embed. `params`
    (this package's dict of tensors) or random weights drawn from
    `seed`. The mesh (`mesh`, or `serving.mesh` over `device`, as the
    generation engine builds it) places the weights by
    `bert.param_specs`; with more than one coordinate `bert.encode`
    runs over it (the batch over data x fsdp, heads and FFN columns
    over tensor, the kernel once per data block x tensor shard).

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
        serving: Optional[ServingConfig] = None,
        mesh: Optional[mesh_mod.Mesh] = None,
    ):
        self.cfg = cfg
        serving = serving or ServingConfig()
        if mesh is None:
            mesh = mesh_mod.serving_mesh(serving.mesh, device)
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0])
        if params is None:
            params = bert_mod.init_params(cfg, self.device, seed)
            logger.info(
                "initialized %s on %s: %.1fM params", cfg.name, self.device,
                count_params(params) / 1e6,
            )
        # Sharding downgrades, counted as the generation engine counts.
        self.spec_downgrades = 0
        self._downgrades_seen: set = set()
        if mesh.size > 1:
            params = bert_mod.shard_params(
                params, cfg, mesh, on_downgrade=self._note_downgrade)
        self.params = params
        # The embed sidecar's one persistent allocation is its weights.
        self.ledger = MemoryLedger(mesh.distinct_devices(),
                                   serving.observability.enabled)
        self.ledger.register("weights", lambda: self.params)
        _watch_compiles(serving)

    _note_downgrade = GenerationEngine._note_downgrade

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
    mesh = engine.mesh
    return {
        "model_id": engine.cfg.name,
        "family": family,
        "num_params_million": int(count_params(engine.params) / 1e6),
        "max_seq_len": engine.cfg.max_seq_len,
        "dtype": engine.cfg.dtype,
        "mesh": {a: n for a, n in mesh.shape.items() if n > 1},
        "num_devices": mesh.size,
        "platform": engine.device.type,
    }
