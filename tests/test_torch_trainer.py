"""The port's trainer loop (models/trainer.py), mirroring
`tests/test_trainer.py` case by case on the CPU: synthetic and text data
at tensor=2, a MoE model, bert refused, a non-finite loss raising; save,
resume and no-resume; the
weights-only checkpoint served through `serving.checkpoint_path` (and
the draft's through `speculative_draft_checkpoint`), an Orbax tree
refused naming it; `_data_stream`'s batches equal the JAX package's
byte for byte; the loop's log lines; CUDA asked for by default."""

import json
import logging

import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import TrainingConfig as JTraining
from ggrmcp_tpu.models import trainer as jtrainer
from ggrmcp_tpu_torch.core.config import (
    MeshConfig,
    ServingConfig,
    TrainingConfig,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import trainer
from ggrmcp_tpu_torch.serving import checkpoint
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401


def tcfg(tmp_path=None, **kw) -> TrainingConfig:
    kw.setdefault("model", "tiny-llama")
    kw.setdefault("steps", 3)
    kw.setdefault("batch_size", 4)
    kw.setdefault("seq_len", 32)
    kw.setdefault("mesh", MeshConfig(tensor=2, data=0))
    kw.setdefault("log_every_steps", 1)
    if tmp_path is not None:
        kw.setdefault("checkpoint_dir", str(tmp_path / "ckpt"))
    return TrainingConfig(**kw)


def _train(cfg):
    return trainer.train(cfg, device="cpu")


class TestLoop:
    def test_synthetic_steps_finite_loss(self, caplog):
        with caplog.at_level(logging.INFO, logger="ggrmcp.torch.models"):
            state = _train(tcfg())
        assert state.step == 3
        losses = [float(r.getMessage().split("loss=")[1].split()[0])
                  for r in caplog.records if "loss=" in r.getMessage()]
        assert len(losses) == 3 and all(np.isfinite(losses))

    def test_text_data(self, tmp_path):
        data = tmp_path / "corpus.txt"
        data.write_text("the quick brown fox jumps over the lazy dog " * 40)
        state = _train(tcfg(steps=2, data_path=str(data)))
        assert state.step == 2

    def test_moe_model_trains(self):
        state = _train(tcfg(model="tiny-moe", steps=2))
        assert state.step == 2

    def test_bert_rejected(self):
        with pytest.raises(ValueError, match="decoder"):
            _train(tcfg(model="bert-tiny"))

    def test_cuda_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.train(tcfg(steps=1))

    def test_non_finite_loss_raises(self):
        """An overflowing learning rate makes the loss non-finite; the
        loop stops at the first logged step that shows it."""
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            _train(tcfg(steps=3, learning_rate=1e20,
                        mesh=MeshConfig(tensor=1)))

    def test_data_and_fsdp_refused(self, caplog):
        """Once refused (ROADMAP A18b), the data axes train: the batch
        splits over them and the logged losses are data=1's; so does a
        sequence axis, replicated (once refused too)."""
        logs = []
        for mesh in (MeshConfig(tensor=1, data=2), MeshConfig(tensor=1),
                     MeshConfig(tensor=1, fsdp=2),
                     MeshConfig(tensor=1, sequence=2)):
            caplog.clear()
            with caplog.at_level(logging.INFO, logger="ggrmcp.torch.models"):
                assert _train(tcfg(mesh=mesh)).step == 3
            logs.append([float(r.getMessage().split("loss=")[1].split()[0])
                         for r in caplog.records
                         if "loss=" in r.getMessage()])
        assert len(logs[0]) == 3
        np.testing.assert_allclose(logs[0], logs[1], rtol=1e-5)
        np.testing.assert_allclose(logs[2], logs[1], rtol=1e-5)
        np.testing.assert_allclose(logs[3], logs[1], rtol=1e-5)


class TestDataStream:
    @pytest.mark.parametrize("text", [False, True], ids=["synthetic", "text"])
    @pytest.mark.parametrize("start", [0, 5])
    def test_batches_equal_reference(self, tmp_path, text, start):
        kw = dict(seed=3, batch_size=4, seq_len=16)
        if text:
            path = tmp_path / "t.txt"
            path.write_text("héllo wörld, " * 30)
            kw["data_path"] = str(path)
        ours = trainer._data_stream(TrainingConfig(**kw), 300, start)
        ref = jtrainer._data_stream(JTraining(**kw), 300, start)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


class TestCheckpointResume:
    def test_save_then_resume_continues_step_count(self, tmp_path, caplog):
        cfg = tcfg(tmp_path, steps=2, save_every_steps=2)
        _train(cfg)
        assert trainer.latest_step(cfg.checkpoint_dir) == 2
        cfg2 = tcfg(tmp_path, steps=4, save_every_steps=2)
        with caplog.at_level(logging.INFO, logger="ggrmcp.torch.models"):
            state = _train(cfg2)
        assert "resumed from step 2" in caplog.text
        assert state.step == 4
        assert trainer.latest_step(cfg.checkpoint_dir) == 4

    def test_resume_restores_params_and_moments(self, tmp_path):
        """The state checkpoint holds the run exactly: resuming it at one
        step and stepping on equals the uninterrupted state's next step
        on the same batch."""
        cfg = tcfg(tmp_path, steps=2, save_every_steps=2,
                   mesh=MeshConfig(tensor=1))
        state = _train(cfg)
        meta, flat = checkpoint.load(
            f"{cfg.checkpoint_dir}/step_2/state", "cpu")
        assert meta["step"] == 2 and meta["kind"] == "state"
        params, moments = trainer.state_tensors(state, tl.CONFIGS[cfg.model])
        for name, t in {**params, **moments}.items():
            assert torch.equal(flat[name], t), name

    def test_no_resume_starts_fresh(self, tmp_path):
        cfg = tcfg(tmp_path, steps=2, save_every_steps=2)
        _train(cfg)
        cfg2 = tcfg(tmp_path, steps=1, save_every_steps=5, resume=False)
        state = _train(cfg2)
        assert state.step == 1

    def test_params_checkpoint_serves(self, tmp_path):
        """The weights-only checkpoint feeds serving through
        serving.checkpoint_path, on a tensor=2 mesh too."""
        cfg = tcfg(tmp_path, steps=1, save_every_steps=1)
        trained = _train(cfg)
        path = f"{cfg.checkpoint_dir}/step_1/params"
        weights = checkpoint.load_params(path, "cpu")
        whole = trainer.state_tensors(trained, tl.CONFIGS["tiny-llama"])[0]
        assert torch.equal(weights["final_norm"], whole["final_norm"])
        assert torch.equal(weights["layers"]["wqkv"], whole["layers.wqkv"])
        outs = []
        for tensor in (1, 2):
            sc = Sidecar(ServingConfig(
                model="tiny-llama", checkpoint_path=path,
                mesh=MeshConfig(tensor=tensor)), device="cpu")
            out, reasons = sc.generation.generate([[3, 1, 4]], 4)
            assert len(out[0]) <= 4 and reasons[0] in ("stop", "length")
            outs.append(out)
        eng = GenerationEngine(tl.CONFIGS["tiny-llama"], params=weights,
                               device="cpu")
        assert outs[0] == outs[1] == eng.generate([[3, 1, 4]], 4)[0]

    def test_draft_checkpoint_serves(self, tmp_path):
        cfg = tcfg(tmp_path, steps=1, save_every_steps=1)
        _train(cfg)
        path = f"{cfg.checkpoint_dir}/step_1/params"
        eng = GenerationEngine(
            tl.CONFIGS["tiny-llama"],
            ServingConfig(speculative_draft="tiny-llama",
                          speculative_draft_checkpoint=path), device="cpu")
        weights = checkpoint.load_params(path, "cpu")
        assert torch.equal(eng.draft_params["lm_head"], weights["lm_head"])

    def test_orbax_and_foreign_dirs_refused(self, tmp_path):
        orbax = tmp_path / "orbax"
        orbax.mkdir()
        (orbax / "_CHECKPOINT_METADATA").write_text("{}")
        (orbax / "manifest.ocdbt").write_bytes(b"")
        with pytest.raises(ValueError, match="Orbax checkpoint of the JAX"):
            ServingConfig(checkpoint_path=str(orbax))
        with pytest.raises(ValueError, match="speculative_draft_checkpoint"):
            ServingConfig(speculative_draft_checkpoint=str(orbax))
        other = tmp_path / "other"
        other.mkdir()
        (other / "meta.json").write_text(json.dumps({"format": "x"}))
        with pytest.raises(ValueError, match="not a checkpoint of the port"):
            ServingConfig(checkpoint_path=str(other))

    def test_wrong_model_refused(self, tmp_path):
        cfg = tcfg(tmp_path, steps=1, save_every_steps=1)
        _train(cfg)
        with pytest.raises(ValueError, match="holds 'tiny-llama'"):
            Sidecar(ServingConfig(
                model="tiny-mistral",
                checkpoint_path=f"{cfg.checkpoint_dir}/step_1/params"),
                device="cpu")
