"""CLI: `python -m ggrmcp_tpu_torch [gateway|sidecar|train] ...`.

`gateway` (also what bare flags mean, as in the reference CLI) is the
one-process-tree entry: it serves the sidecar in this process and
co-launches the unchanged MCP gateway of the JAX package as a child
(`python -m ggrmcp_tpu gateway`, which loads no JAX) over a private unix
socket, supervising the sidecar (serving/launcher.py). It takes the
reference's flags: `--http-port`, `--log-level`, `--dev` and
`--descriptor` go to the gateway; `--grpc-host/--grpc-port/--backend`
add external backends to its pool (only when given, by flag, config file
or GGRMCP_GRPC_* variable); `--model`, `--quantize`, `--hf-checkpoint`,
`--tokenizer` and `--speculative-draft` configure the sidecar; `--tpu`
is accepted and implied (this gateway always co-launches; run `python -m
ggrmcp_tpu gateway` for a plain one); `--workers` above 1 is refused.

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
PyYAML is installed: "serving" is parsed strictly (an unknown key
raises), "fleet" gives the supervisor's restart backoff, and the
gateway's sections (server, grpc, logging, mcp, metrics, session, tools,
gateway, training, and fleet too) go to the gateway child verbatim.
With `{"fleet": {"enabled": true, "min_replicas": 1, "max_replicas":
2}}` (or GGRMCP_FLEET_ENABLED=1) `gateway` also runs the reference's
replica fleet: the child's supervisor spawns, heals and scales workers
of this port (`python -m ggrmcp_tpu_torch.serving.fleet`), each serving
the same `serving` section, `--device`, `--seed` and serving flags as
the co-launched sidecar, which stays a static backend beside them. E.g. `{"serving":
{"model": "llama3-8b", "quantize": "int8", "kv_cache_dtype": "int8",
"batching": {"max_batch_size": 16}, "mesh": {"tensor": 2}}, "grpc":
{"reconnect": {"watchdog_interval_s": 2}}}`. GGRMCP_SERVING_* and
GGRMCP_FLEET_* variables go over the file, and flags over both. Runs on
CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import signal
import sys

from ggrmcp_tpu_torch.core import config as cfgmod
from ggrmcp_tpu_torch.core.config import QUANTIZE_MODES
from ggrmcp_tpu_torch.models import available_models

SUBCOMMANDS = ("gateway", "sidecar", "train")


def _sidecar_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=None, choices=available_models(),
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
        description="PyTorch/CUDA serving sidecar, its co-launched MCP "
        "gateway, and the trainer",
    )
    sub = parser.add_subparsers(dest="command")
    gw = sub.add_parser(
        SUBCOMMANDS[0],
        help="co-launch the MCP gateway over a supervised sidecar",
        description="Serve the sidecar here and the MCP gateway as a "
        "child over it. With fleet.enabled in --config (or "
        "GGRMCP_FLEET_ENABLED=1) the gateway's fleet supervisor also "
        "runs replica workers of this port; --device, --seed and the "
        "serving flags reach the workers as they reach the sidecar.",
    )
    gw.add_argument("--grpc-host", default=None, help="external backend host")
    gw.add_argument("--grpc-port", type=int, default=None,
                    help="external backend port")
    gw.add_argument("--backend", action="append", default=None,
                    metavar="HOST:PORT",
                    help="external backend; repeat for a pool")
    gw.add_argument("--http-port", type=int, default=None,
                    help="gateway HTTP listen port")
    gw.add_argument("--log-level", default=None,
                    help="debug|info|warning|error")
    gw.add_argument("--dev", action="store_true", help="development mode")
    gw.add_argument("--descriptor", default=None,
                    help="FileDescriptorSet (.binpb) path")
    gw.add_argument("--tpu", action="store_true",
                    help="accepted and implied: this gateway always "
                    "co-launches the sidecar")
    gw.add_argument("--speculative-draft", default=None,
                    help="sidecar draft model for speculative decoding")
    gw.add_argument("--workers", type=int, default=None,
                    help="refused above 1 (each worker would co-launch "
                    "its own sidecar)")
    _sidecar_flags(gw)
    sc = sub.add_parser(SUBCOMMANDS[1], help="run the serving sidecar only")
    sc.add_argument("--port", type=int, default=None,
                    help="gRPC port (default 50051)")
    sc.add_argument("--log-level", default="info")
    _sidecar_flags(sc)
    tr = sub.add_parser(
        SUBCOMMANDS[2], help="train a decoder model (checkpoint/resume)")
    tr.add_argument("--model", default=None, choices=available_models(),
                    help="model registry key")
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
    """Defaults → `--config` file → GGRMCP_SERVING_* / GGRMCP_FLEET_*
    environment → the flags given on the command line."""
    cfg = cfgmod.load(args.config, environ=environ)
    flags = dict(
        model=args.model, port=getattr(args, "port", None),
        quantize=args.quantize,
        hf_checkpoint_path=args.hf_checkpoint or None,
        tokenizer_path=args.tokenizer or None,
        speculative_draft=getattr(args, "speculative_draft", None),
    )
    cfg.serving = dataclasses.replace(
        cfg.serving, **{k: v for k, v in flags.items() if v is not None})
    return cfg


def serving_config(args: argparse.Namespace) -> cfgmod.ServingConfig:
    return load_config(args).serving


def external_backends(args: argparse.Namespace, cfg: cfgmod.Config,
                      environ: dict | None = None) -> list[str]:
    """The gateway pool's external backends, by the reference's rule:
    only when one was given explicitly — `--backend`, `--grpc-host` /
    `--grpc-port`, or a config file or GGRMCP_GRPC_HOST / _PORT that
    moves grpc's target off its built-in placeholder."""
    if args.backend:
        return list(args.backend)
    environ = os.environ if environ is None else environ
    grpc_cfg = cfg.sections.get("grpc", {})
    host = (args.grpc_host or environ.get("GGRMCP_GRPC_HOST")
            or grpc_cfg.get("host", "localhost"))
    port = (args.grpc_port or environ.get("GGRMCP_GRPC_PORT")
            or grpc_cfg.get("port", 50051))
    target = f"{host}:{port}"
    explicit = bool(args.grpc_host or args.grpc_port
                    or target != "localhost:50051")
    return [target] if explicit else []


def gateway_flags(args: argparse.Namespace) -> list[str]:
    """The flags the gateway child takes from ours."""
    out: list[str] = []
    if args.http_port is not None:
        out += ["--http-port", str(args.http_port)]
    if args.log_level:
        out += ["--log-level", args.log_level]
    if args.dev:
        out.append("--dev")
    if args.descriptor:
        out += ["--descriptor", args.descriptor]
    return out


def _workers(args: argparse.Namespace, cfg: cfgmod.Config) -> int:
    if args.workers is not None:
        return args.workers
    env = os.environ.get("GGRMCP_SERVER_WORKERS")
    return int(env) if env else int(
        cfg.sections.get("server", {}).get("workers", 1))


async def _serve(args: argparse.Namespace) -> None:
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    sidecar = Sidecar(serving_config(args), seed=args.seed, device=args.device)
    await sidecar.start()
    try:
        await sidecar.server.wait_for_termination()
    finally:
        await sidecar.stop()


async def _colaunch(args: argparse.Namespace, cfg: cfgmod.Config) -> None:
    from ggrmcp_tpu_torch.serving.launcher import Colaunch, run_colaunch

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    colaunch = Colaunch(cfg, gateway_flags(args),
                        external_backends(args, cfg),
                        device=args.device, seed=args.seed)
    await run_colaunch(colaunch, stop)


def parse_args(argv) -> argparse.Namespace:
    """The reference CLI's rule: bare flags (or none) imply `gateway`."""
    argv = list(argv)
    if not argv or argv[0] not in (*SUBCOMMANDS, "-h", "--help"):
        argv = ["gateway", *argv]
    return build_parser().parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=getattr(logging, (args.log_level or "info").upper(),
                      logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.command == "sidecar":
        asyncio.run(_serve(args))
        return 0
    if args.command == "train":
        from ggrmcp_tpu_torch.models.trainer import train

        train(training_config(args), device=args.device)
        return 0
    cfg = load_config(args)
    if _workers(args, cfg) > 1:
        raise SystemExit(
            "--workers > 1 is incompatible with the co-launched sidecar "
            "(each worker would co-launch its own); run the sidecar "
            "separately and point `python -m ggrmcp_tpu gateway "
            "--backend` at it"
        )
    asyncio.run(_colaunch(args, cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
