"""The port's CLI and config loading against the reference's
(`tests/test_cli.py`, `ggrmcp_tpu/core/config.py::load`): parser flags,
`train` on the CPU (CUDA asked for without `--device cpu`) with the
reference's training section, the precedence defaults → file →
environment → flags, bare flags implying `gateway`, `--workers` refused
with the co-launch, the
reference's rule for external backends, and whole reference config files
(gateway sections included) loading as JSON and as YAML, with every
serving key the reference also reads taking the reference's value and an
unknown serving key still refused."""

import argparse
import json
import sys

import pytest

from ggrmcp_tpu.core import config as jcfg
from ggrmcp_tpu_torch import __main__ as cli
from ggrmcp_tpu_torch.core import config as tcfg
from tests import torch_threads  # noqa: F401

# A reference config file: gateway sections, the fleet's knobs and a
# serving section of keys both packages read.
WHOLE = {
    "server": {"port": 8088, "host": "127.0.0.1", "request_timeout_s": 12.5},
    "grpc": {"reconnect": {"watchdog_interval_s": 2.0}},
    "logging": {"level": "warning"},
    "mcp": {}, "metrics": {"enabled": True}, "session": {}, "tools": {},
    "gateway": {}, "training": {"steps": 3},
    "fleet": {"backoff_base_s": 0.5, "backoff_max_s": 4.0,
              "restart_max_attempts": 3, "min_replicas": 1},
    "serving": {
        "model": "tiny-llama", "dtype": "bfloat16", "quantize": "int8",
        "colaunch_uds": False, "hf_checkpoint_optional": True,
        "sp_prefill": "ulysses", "sp_prefill_min_seq": 512,
        "uds_path": "/tmp/ggrmcp-x.sock",
        "batching": {"max_batch_size": 8, "prefill_chunk": 64},
        "mesh": {"tensor": 1},
    },
}
SERVING_KEYS = ("model", "dtype", "quantize", "colaunch_uds",
                "hf_checkpoint_optional", "sp_prefill", "sp_prefill_min_seq",
                "uds_path", "port")


def _assert_matches_reference(cfg: tcfg.Config, ref: jcfg.Config) -> None:
    for key in SERVING_KEYS:
        assert getattr(cfg.serving, key) == getattr(ref.serving, key), key
    for key in ("max_batch_size", "prefill_chunk", "kv_cache_max_seq"):
        assert (getattr(cfg.serving.batching, key)
                == getattr(ref.serving.batching, key)), key
    for key in ("backoff_base_s", "backoff_max_s", "backoff_jitter",
                "restart_max_attempts"):
        assert getattr(cfg.fleet, key) == getattr(ref.fleet, key), key


class TestParser:
    def test_gateway_flags(self):
        args = cli.parse_args([
            "gateway", "--grpc-host", "h", "--grpc-port", "9",
            "--http-port", "8", "--log-level", "debug", "--dev",
            "--descriptor", "d.binpb", "--backend", "a:1",
            "--backend", "b:2", "--workers", "1", "--tpu",
            "--model", "tiny-llama", "--quantize", "int8",
            "--hf-checkpoint", "ck", "--tokenizer", "t.json",
            "--speculative-draft", "tiny-llama", "--device", "cpu",
            "--seed", "3", "--config", "c.json",
        ])
        assert args.command == "gateway" and args.tpu
        assert (args.grpc_host, args.grpc_port, args.http_port) == ("h", 9, 8)
        assert args.backend == ["a:1", "b:2"] and args.dev
        assert (args.device, args.seed, args.config) == ("cpu", 3, "c.json")
        assert cli.gateway_flags(args) == [
            "--http-port", "8", "--log-level", "debug", "--dev",
            "--descriptor", "d.binpb"]

    def test_sidecar_flags(self):
        args = cli.parse_args(["sidecar", "--port", "7", "--model",
                               "tiny-llama", "--quantize", "int8"])
        assert args.command == "sidecar" and args.port == 7

    @pytest.mark.parametrize("argv", [[], ["--http-port", "8"],
                                      ["--model", "tiny-llama", "--dev"]])
    def test_bare_flags_imply_gateway(self, argv):
        assert cli.parse_args(argv).command == "gateway"

    def test_train_is_not_ported(self):
        """Training was the last subcommand left to port (ROADMAP A19c):
        `train` now parses the reference's flags, and the help no longer
        names it as missing."""
        args = cli.parse_args(["train", "--steps", "5", "--batch-size", "2",
                               "--seq-len", "16", "--learning-rate", "0.1",
                               "--checkpoint-dir", "ck", "--save-every", "2",
                               "--no-resume", "--data", "d.txt",
                               "--model", "tiny-moe", "--device", "cpu",
                               "--log-level", "debug"])
        assert args.command == "train" and args.steps == 5
        assert "A19c" not in cli.build_parser().description
        tc = cli.training_config(args, environ={})
        assert (tc.model, tc.steps, tc.batch_size, tc.seq_len,
                tc.learning_rate, tc.checkpoint_dir, tc.save_every_steps,
                tc.resume, tc.data_path) == (
            "tiny-moe", 5, 2, 16, 0.1, "ck", 2, False, "d.txt")

    @pytest.mark.parametrize("how", ["flag", "file"])
    def test_workers_refused_with_colaunch(self, how, tmp_path, capsys):
        argv = ["gateway", "--device", "cpu"]
        if how == "flag":
            argv += ["--workers", "2"]
        else:
            path = tmp_path / "w.json"
            path.write_text(json.dumps({"server": {"workers": 2}}))
            argv += ["--config", str(path)]
        with pytest.raises(SystemExit, match="--workers > 1"):
            cli.main(argv)


class TestPrecedence:
    def test_defaults_file_env_flags(self, tmp_path):
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"serving": {
            "model": "tiny-mistral", "port": 1111,
            "batching": {"max_batch_size": 5}}}))
        env = {"GGRMCP_SERVING_PORT": "2222",
               "GGRMCP_SERVING_BATCHING_PREFILL_CHUNK": "32",
               "GGRMCP_FLEET_BACKOFF_BASE_S": "0.25",
               "GGRMCP_SERVING_COLAUNCH_UDS": "off",
               "GGRMCP_SERVER_PORT": "9",  # the gateway's, not ours
               "GGRMCP_FLEET_WORKER_ID": "x"}  # a handshake, not a path
        args = cli.parse_args(["sidecar", "--config", str(path),
                               "--model", "tiny-llama"])
        cfg = cli.load_config(args, environ=env)
        assert cfg.serving.model == "tiny-llama"  # flag over file
        assert cfg.serving.port == 2222  # env over file
        assert cfg.serving.batching.max_batch_size == 5  # file over default
        assert cfg.serving.batching.prefill_chunk == 32
        assert cfg.serving.colaunch_uds is False
        assert cfg.fleet.backoff_base_s == 0.25
        assert cfg.serving.quantize == ""  # default
        # The reference's loader reads the same file and environment to
        # the same values (its flags go on after, as ours do).
        ref = jcfg.load_file(str(path))
        jcfg.apply_env(ref, {k: v for k, v in env.items()
                             if not k.startswith("GGRMCP_SERVER")})
        ref.serving.model = "tiny-llama"
        _assert_matches_reference(cfg, ref)

    @pytest.mark.parametrize("var", ["GGRMCP_SERVING_NOPE",
                                     "GGRMCP_SERVING_BATCHING",
                                     "GGRMCP_FLEET_BACKOFF"])
    def test_bad_env_var_raises(self, var):
        with pytest.raises(ValueError, match=var):
            tcfg.load(environ={var: "1"})

    def test_env_boolean_coercion_refuses_junk(self):
        with pytest.raises(ValueError, match="expected boolean"):
            tcfg.load(environ={"GGRMCP_SERVING_COLAUNCH_UDS": "maybe"})


class TestWholeFiles:
    @pytest.mark.parametrize("fmt", ["json", "yaml"])
    def test_reference_file_loads_whole(self, fmt, tmp_path):
        if fmt == "yaml":
            yaml = pytest.importorskip("yaml")
            path = tmp_path / "ref.yaml"
            path.write_text(yaml.safe_dump(WHOLE))
        else:
            path = tmp_path / "ref.json"
            path.write_text(json.dumps(WHOLE))
        cfg = tcfg.load(str(path), environ={})
        ref = jcfg.load(str(path), env=False)  # the reference takes it too
        _assert_matches_reference(cfg, ref)
        assert cfg.sections == {k: v for k, v in WHOLE.items()
                                if k != "serving"}

    def test_yaml_without_pyyaml_names_the_file(self, tmp_path, monkeypatch):
        path = tmp_path / "ref.yml"
        path.write_text("serving: {}\n")
        monkeypatch.setitem(sys.modules, "yaml", None)
        with pytest.raises(ValueError, match="ref.yml.*PyYAML"):
            tcfg.load(str(path), environ={})

    @pytest.mark.parametrize("data,match", [
        ({"serving": {"modle": "x"}}, "modle"),
        ({"serving": {"batching": {"max_batch": 2}}}, "max_batch"),
        ({"servr": {}}, "top-level"),
        ({"fleet": {"enabled": True}}, "fleet.enabled"),
        ({"fleet": {"backoff_jitter": 1.5}}, "backoff_jitter"),
        ({"serving": {"sp_prefill": "zigzag"}}, "sp_prefill"),
        ({"training": {"stepz": 3}}, "stepz"),
        ({"training": {"seq_len": 1}}, "seq_len"),
    ])
    def test_unknown_or_bad_keys_raise(self, data, match, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(data))
        with pytest.raises(ValueError, match=match):
            tcfg.load(str(path), environ={})


@pytest.mark.parametrize("argv,sections,env", [
    ([], {}, {}),
    (["--backend", "a:1", "--backend", "b:2"], {}, {}),
    (["--grpc-host", "h"], {}, {}),
    (["--grpc-port", "7"], {}, {}),
    ([], {"grpc": {"host": "remote", "port": 9}}, {}),
    ([], {"grpc": {"max_message_bytes": 1024}}, {}),  # logging-only style
    ([], {}, {"GGRMCP_GRPC_HOST": "envhost"}),
])
def test_external_backends_follow_reference_rule(argv, sections, env,
                                                 monkeypatch):
    """The reference's `explicit` rule (ggrmcp_tpu/__main__.py): an
    external backend joins the co-launched pool only when given."""
    for k in ("GGRMCP_GRPC_HOST", "GGRMCP_GRPC_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = cli.parse_args(["gateway", *argv])
    got = cli.external_backends(args, tcfg.Config(sections=sections), env)
    ref = jcfg.default()
    jcfg._merge(ref, sections)
    jcfg.apply_env(ref, env)
    if args.grpc_host:
        ref.grpc.host = args.grpc_host
    if args.grpc_port:
        ref.grpc.port = args.grpc_port
    explicit = bool(args.backend or args.grpc_host or args.grpc_port
                    or ref.grpc.target != jcfg.GRPCConfig().target)
    want = (args.backend or [ref.grpc.target]) if explicit else []
    assert got == want


def test_serving_config_flags_over_file(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"serving": {"quantize": "int8",
                                            "batching": {"max_batch_size": 2}}}))
    args = cli.parse_args(["sidecar", "--config", str(path), "--port", "7"])
    cfg = cli.serving_config(args)
    assert (cfg.quantize, cfg.port, cfg.batching.max_batch_size) == (
        "int8", 7, 2)
    assert isinstance(args, argparse.Namespace)


class TestTrain:
    def test_train_on_cpu_writes_checkpoints(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"training": {
            "log_every_steps": 1, "seed": 4, "weight_decay": 0.0}}))
        ref = jcfg.load(str(path), env=False).training
        args = cli.parse_args(["train", "--config", str(path)])
        ours = cli.training_config(args, environ={})
        for key in ("model", "steps", "batch_size", "seq_len",
                    "learning_rate", "weight_decay", "checkpoint_dir",
                    "save_every_steps", "resume", "data_path",
                    "log_every_steps", "seed"):
            assert getattr(ours, key) == getattr(ref, key), key
        ck = tmp_path / "ck"
        assert cli.main(["train", "--model", "tiny-llama", "--steps", "2",
                         "--batch-size", "2", "--seq-len", "16",
                         "--device", "cpu", "--checkpoint-dir", str(ck),
                         "--save-every", "2", "--config", str(path)]) == 0
        assert sorted(p.name for p in ck.iterdir()) == ["step_2"]
        assert sorted(p.name for p in (ck / "step_2").iterdir()) == [
            "params", "state"]

    def test_train_asks_for_cuda(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train", "--steps", "1", "--seq-len", "8"])

    def test_training_env_under_flags(self):
        env = {"GGRMCP_TRAINING_STEPS": "7", "GGRMCP_TRAINING_SEED": "9"}
        ours = cli.training_config(cli.parse_args(["train"]), environ=env)
        assert (ours.steps, ours.seed) == (7, 9)
        ours = cli.training_config(cli.parse_args(["train", "--steps", "2"]),
                                   environ=env)
        assert ours.steps == 2
