"""CLI: `python -m ggrmcp_tpu_torch [gateway|sidecar|train] ...`.

`gateway` (also what bare flags mean, as in the reference CLI) runs the
port's MCP gateway (gateway/app.py) with the reference's flags and their
meanings (`ggrmcp_tpu/__main__.py`):
- without `--tpu`, the plain gateway over `--backend` targets (repeat
  for a pool) or `--grpc-host` / `--grpc-port`; `--workers N` runs N
  gateway processes on one port (SO_REUSEPORT). This path loads no
  torch.
- with `--tpu`, the co-launch (serving/launcher.py): the gateway and the
  port's sidecar on one event loop in this process, over a private unix
  socket, the sidecar supervised; `--model`, `--quantize`,
  `--hf-checkpoint`, `--tokenizer` and `--speculative-draft` configure
  the sidecar, and an external backend joins the pool only when one was
  given (by flag, config file or GGRMCP_GRPC_* variable). `--workers`
  above 1 is refused, as in the reference.
`--http-port`, `--log-level`, `--dev` and `--descriptor` set the
gateway. `--device` (default the card; 'cpu' only when asked) and
`--seed` (random weights) apply to the co-launched sidecar and to the
workers of the replica fleet: with `{"fleet": {"enabled": true,
"min_replicas": 1, "max_replicas": 2}}` (or GGRMCP_FLEET_ENABLED=1) the
gateway's supervisor spawns, heals and scales workers of this port
(`python -m ggrmcp_tpu_torch.serving.fleet`), each serving the
`serving` section, device and seed.

`train` runs the training loop (models/trainer.py) with the reference's
flags (`--model`, `--steps`, `--batch-size`, `--seq-len`,
`--learning-rate`, `--checkpoint-dir`, `--save-every`, `--no-resume`,
`--data`, `--config`, `--log-level`) over the config file's `training`
section; its checkpoints (`<dir>/step_N/params`) are what
`serving.checkpoint_path` serves.

`sidecar` serves the sidecar alone over gRPC (`--port`, TCP; or a
`serving.uds_path` socket): a llama or sparse-MoE model (or any HF
Llama/Mistral checkpoint given by `--hf-checkpoint`, which overrides
`--model`) serves Generate / GenerateStream; a bert model serves Embed.
Both serve GetModelInfo / GetServingStats. Without a checkpoint the
weights are random, drawn from `--seed`. `--tokenizer` takes a HF
tokenizer.json and needs the `tokenizers` package. `--quantize int8`
serves int8 weights.

`--config` takes a whole reference config file, JSON, or YAML where
PyYAML is installed: every section is parsed, "serving" and "training"
strictly (an unknown key raises). E.g. `{"serving": {"model":
"llama3-8b", "quantize": "int8", "batching": {"max_batch_size": 16},
"mesh": {"tensor": 2}}, "grpc": {"reconnect": {"watchdog_interval_s":
2}}}`. GGRMCP_* variables go over the file, and flags over both.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import sys

from ggrmcp_tpu_torch.core import config as cfgmod
from ggrmcp_tpu_torch.core.config import QUANTIZE_MODES

SUBCOMMANDS = ("gateway", "sidecar", "train")


class _ModelNames:
    """The registry's model names as `--model`'s choices, read when a
    name is checked (never while the parser is built: `--model` names
    its metavar): the registry imports torch, which the plain gateway
    never loads."""

    @staticmethod
    def _names() -> list[str]:
        from ggrmcp_tpu_torch.models import available_models

        return available_models()

    def __contains__(self, name) -> bool:
        return name in self._names()

    def __iter__(self):
        return iter(self._names())


def _sidecar_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=None, choices=_ModelNames(),
                   metavar="MODEL",
                   help="model registry key (default tiny-llama)")
    p.add_argument(
        "--hf-checkpoint", default="",
        help="HuggingFace Llama/Mistral checkpoint dir (config.json + "
        "safetensors); overrides --model",
    )
    p.add_argument(
        "--tokenizer", default="",
        help="HuggingFace tokenizer.json path (needs `tokenizers`)",
    )
    p.add_argument("--quantize", default=None,
                   choices=[m for m in QUANTIZE_MODES if m],
                   help="weight quantization (int8)")
    p.add_argument("--config", default=None,
                   help="reference config file (JSON, or YAML with PyYAML)")
    p.add_argument(
        "--device", default=None,
        help="torch device (default cuda; 'cpu' only when asked)",
    )
    p.add_argument("--seed", type=int, default=0, help="random-weight seed")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ggrmcp_tpu_torch",
        description="The MCP gateway, the PyTorch/CUDA serving sidecar "
        "it co-launches, and the trainer",
    )
    sub = parser.add_subparsers(dest="command")
    gw = sub.add_parser(
        SUBCOMMANDS[0], help="run the MCP gateway",
        description="The MCP gateway over gRPC backends; with --tpu it "
        "also serves a supervised sidecar of this port in its process. "
        "With fleet.enabled in --config (or GGRMCP_FLEET_ENABLED=1) its "
        "fleet supervisor runs replica workers of this port; --device, "
        "--seed and the serving flags reach the workers as they reach "
        "the sidecar.",
    )
    gw.add_argument("--grpc-host", default=None, help="backend gRPC host")
    gw.add_argument("--grpc-port", type=int, default=None,
                    help="backend gRPC port")
    gw.add_argument("--http-port", type=int, default=None,
                    help="HTTP listen port")
    gw.add_argument("--log-level", default=None,
                    help="debug|info|warning|error")
    gw.add_argument("--dev", action="store_true", help="development mode")
    gw.add_argument("--descriptor", default=None,
                    help="FileDescriptorSet (.binpb) path")
    gw.add_argument("--backend", action="append", default=None,
                    metavar="HOST:PORT",
                    help="backend target; repeat for a pool (overrides "
                    "--grpc-host/port)")
    gw.add_argument("--tpu", action="store_true",
                    help="co-launch the port's serving sidecar in this "
                    "process and register it")
    gw.add_argument("--speculative-draft", default=None,
                    help="sidecar draft model for speculative decoding "
                    "(with --tpu)")
    gw.add_argument("--workers", type=int, default=None,
                    help="gateway worker processes sharing the port "
                    "(SO_REUSEPORT)")
    _sidecar_flags(gw)
    sc = sub.add_parser(SUBCOMMANDS[1], help="run the serving sidecar only")
    sc.add_argument("--port", type=int, default=None,
                    help="gRPC port (default 50051)")
    sc.add_argument("--log-level", default="info")
    _sidecar_flags(sc)
    tr = sub.add_parser(
        SUBCOMMANDS[2], help="train a decoder model (checkpoint/resume)")
    tr.add_argument("--model", default=None, choices=_ModelNames(),
                    metavar="MODEL", help="model registry key")
    tr.add_argument("--steps", type=int, default=None)
    tr.add_argument("--batch-size", type=int, default=None)
    tr.add_argument("--seq-len", type=int, default=None)
    tr.add_argument("--learning-rate", type=float, default=None)
    tr.add_argument("--checkpoint-dir", default=None,
                    help="root for step_N/{state,params} checkpoints")
    tr.add_argument("--save-every", type=int, default=None)
    tr.add_argument("--no-resume", action="store_true",
                    help="start fresh even if checkpoints exist")
    tr.add_argument("--data", default=None, help="raw text file to train on")
    tr.add_argument("--config", default=None,
                    help="reference config file (JSON, or YAML with PyYAML)")
    tr.add_argument("--log-level", default=None)
    tr.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' only when asked)")
    return parser


def training_config(args: argparse.Namespace,
                    environ: dict | None = None) -> cfgmod.TrainingConfig:
    """The `training` section of defaults → `--config` file →
    GGRMCP_TRAINING_* environment → the train flags given."""
    tc = cfgmod.load(args.config, environ=environ).training
    flags = dict(
        model=args.model, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, learning_rate=args.learning_rate,
        checkpoint_dir=args.checkpoint_dir, save_every_steps=args.save_every,
        data_path=args.data, resume=False if args.no_resume else None)
    return dataclasses.replace(
        tc, **{k: v for k, v in flags.items() if v is not None})


def load_config(args: argparse.Namespace,
                environ: dict | None = None) -> cfgmod.Config:
    """Defaults (development ones with `--dev`) → `--config` file →
    GGRMCP_* environment → the flags given on the command line, as the
    reference's `load_config` applies them."""
    cfg = cfgmod.load(args.config, environ=environ,
                      dev=getattr(args, "dev", False))
    if getattr(args, "grpc_host", None):
        cfg.grpc.host = args.grpc_host
    if getattr(args, "grpc_port", None):
        cfg.grpc.port = args.grpc_port
    if getattr(args, "http_port", None):
        cfg.server.port = args.http_port
    if getattr(args, "log_level", None):
        cfg.logging.level = args.log_level
    if getattr(args, "descriptor", None):
        cfg.grpc.descriptor_set.enabled = True
        cfg.grpc.descriptor_set.path = args.descriptor
    if getattr(args, "workers", None):
        cfg.server.workers = args.workers
    flags = dict(
        model=args.model, port=getattr(args, "port", None),
        quantize=args.quantize,
        hf_checkpoint_path=args.hf_checkpoint or None,
        tokenizer_path=args.tokenizer or None,
        speculative_draft=getattr(args, "speculative_draft", None),
    )
    cfg.serving = dataclasses.replace(
        cfg.serving, **{k: v for k, v in flags.items() if v is not None})
    cfg.validate()
    return cfg


def serving_config(args: argparse.Namespace) -> cfgmod.ServingConfig:
    return load_config(args).serving


def external_backends(args: argparse.Namespace,
                      cfg: cfgmod.Config) -> list[str]:
    """The co-launched pool's external backends, by the reference's
    rule: only when one was given explicitly — `--backend`,
    `--grpc-host` / `--grpc-port`, or a config file or GGRMCP_GRPC_HOST
    / _PORT that moves grpc's target off its built-in placeholder
    (`cfg` carries the flags already)."""
    explicit = bool(args.backend or args.grpc_host or args.grpc_port
                    or cfg.grpc.target != cfgmod.GRPCConfig().target)
    if not explicit:
        return []
    return list(args.backend) if args.backend else [cfg.grpc.target]


async def _serve(args: argparse.Namespace) -> None:
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    sidecar = Sidecar(serving_config(args), seed=args.seed, device=args.device)
    await sidecar.start()
    try:
        await sidecar.server.wait_for_termination()
    finally:
        await sidecar.stop()


def parse_args(argv) -> argparse.Namespace:
    """The reference CLI's rule: bare flags (or none) imply `gateway`."""
    argv = list(argv)
    if not argv or argv[0] not in (*SUBCOMMANDS, "-h", "--help"):
        argv = ["gateway", *argv]
    return build_parser().parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "sidecar":
        _basic_logging(args.log_level)
        asyncio.run(_serve(args))
        return 0
    if args.command == "train":
        from ggrmcp_tpu_torch.models.trainer import train

        _basic_logging(args.log_level)
        train(training_config(args), device=args.device)
        return 0
    cfg = load_config(args)
    targets = args.backend if args.backend else [cfg.grpc.target]
    if cfg.server.workers > 1:
        if args.tpu:
            raise SystemExit(
                "--workers > 1 is incompatible with --tpu (each worker "
                "would co-launch its own sidecar); run the sidecar "
                "separately and point --backend at it"
            )
        from ggrmcp_tpu_torch.gateway.app import run_multiworker

        run_multiworker(cfg, targets)
        return 0
    if args.tpu:
        from ggrmcp_tpu_torch.serving.launcher import run_gateway_with_sidecar

        run_gateway_with_sidecar(cfg, external_backends(args, cfg),
                                 device=args.device, seed=args.seed)
    else:
        from ggrmcp_tpu_torch.gateway.app import run

        run(cfg, targets, worker_device=args.device, worker_seed=args.seed)
    return 0


def _basic_logging(level) -> None:
    logging.basicConfig(
        level=getattr(logging, (level or "info").upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


if __name__ == "__main__":
    sys.exit(main())
