"""CLI: `python -m ggrmcp_tpu_torch sidecar --model NAME --port N
[--hf-checkpoint DIR] [--tokenizer FILE] [--quantize int8]
[--config FILE] [--device cpu] [--seed S]`.

A llama or sparse-MoE model (or any HF Llama/Mistral checkpoint given
by `--hf-checkpoint`, which overrides `--model`) serves Generate /
GenerateStream; a bert model serves Embed. Both serve GetModelInfo /
GetServingStats over gRPC. Without a checkpoint the weights are random,
drawn from `--seed`. `--tokenizer` takes a HF tokenizer.json and needs
the `tokenizers` package. `--quantize int8` serves int8 weights.
`--config` reads a JSON file in the reference's layout, everything
nested under "serving" (e.g. `{"serving": {"model": "llama3-8b",
"quantize": "int8", "kv_cache_dtype": "int8", "batching":
{"max_batch_size": 16}, "grammar": {"jump_max": 8}}}`); a flag given on
the command line overrides the file. The file also takes the replica's
`role` ("mixed", "prefill", "decode"; a non-mixed role needs
`"batching": {"paged_kv": "on"}`), multi-LoRA (`"lora": {"registry":
DIR, "rank": 8, "arena_rows": 8}` or `{"adapters": [...], "path":
DIR}`) and the host page tier (`"batching": {"paged_kv_host_bytes": N,
"paged_kv_host_path": FILE}`), a depth cut of a registry model
(`"num_layers": 16`: mixtral-8x7b at full width on one 80 GB card) and
the device mesh (`"mesh": {"tensor": 2}`, `{"tensor": 2, "expert": 2}`
for a MoE model: tensor and expert parallelism over every card, or over
the CPU repeated with `--device cpu`); an unknown key raises. Runs on
CUDA unless `--device cpu` is given. Put the reference gateway in front of
it: `python -m ggrmcp_tpu gateway --grpc-port N`.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import sys

from ggrmcp_tpu_torch.core.config import (
    QUANTIZE_MODES,
    ServingConfig,
    load_serving_config,
)
from ggrmcp_tpu_torch.models import available_models


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ggrmcp_tpu_torch",
        description="PyTorch/CUDA serving sidecar (gRPC)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    sc = sub.add_parser("sidecar", help="run the serving sidecar")
    sc.add_argument("--model", default=None, choices=available_models(),
                    help="model registry key (default tiny-llama)")
    sc.add_argument(
        "--hf-checkpoint", default="",
        help="HuggingFace Llama/Mistral checkpoint dir (config.json + "
        "safetensors); overrides --model",
    )
    sc.add_argument(
        "--tokenizer", default="",
        help="HuggingFace tokenizer.json path (needs `tokenizers`)",
    )
    sc.add_argument("--quantize", default=None,
                    choices=[m for m in QUANTIZE_MODES if m],
                    help="weight quantization (int8)")
    sc.add_argument(
        "--config", default=None,
        help="JSON config file, settings nested under \"serving\"",
    )
    sc.add_argument("--port", type=int, default=None,
                    help="gRPC port (default 50051)")
    sc.add_argument(
        "--device", default=None,
        help="torch device (default cuda; 'cpu' only when asked)",
    )
    sc.add_argument("--seed", type=int, default=0, help="random-weight seed")
    sc.add_argument("--log-level", default="info")
    return parser


def serving_config(args: argparse.Namespace) -> ServingConfig:
    """The config file's settings (or the defaults), with every flag
    given on the command line put over them."""
    base = load_serving_config(args.config) if args.config else ServingConfig()
    flags = dict(
        model=args.model, port=args.port, quantize=args.quantize,
        hf_checkpoint_path=args.hf_checkpoint or None,
        tokenizer_path=args.tokenizer or None,
    )
    return dataclasses.replace(
        base, **{k: v for k, v in flags.items() if v is not None}
    )


async def _serve(args: argparse.Namespace) -> None:
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    sidecar = Sidecar(serving_config(args), seed=args.seed, device=args.device)
    await sidecar.start()
    try:
        await sidecar.server.wait_for_termination()
    finally:
        await sidecar.stop()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.command == "sidecar":
        asyncio.run(_serve(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
