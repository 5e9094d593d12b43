"""The plain reference against the port's forward at its tiny presets on
the CPU (float32 both sides): tiny-mistral, and tiny-moe-sw at
capacity_factor = E/k, where no pair drops. The float8 control departs
from it by far more, the bfloat16 witness by less than the control."""

import dataclasses

import pytest
import torch

from perfbench import model
from perfbench.reference.plain import Plain
from perfbench.tests import tiny


def _port(name):
    from ggrmcp_tpu_torch.models import llama, moe

    cfg = tiny.CONFIGS[name]
    if cfg["family"] == "moe":
        port = dataclasses.replace(moe.CONFIGS[cfg["port"]["preset"]],
                                   **cfg["port"]["overrides"])
        return port, moe.forward
    return llama.CONFIGS[cfg["port"]["preset"]], llama.forward


@pytest.mark.parametrize("name", sorted(tiny.CONFIGS))
def test_reference_is_the_port(name):
    m = model.shape(dict(tiny.CONFIGS[name], name=name))
    port_cfg, forward = _port(name)
    weights = model.make_weights(m, 2**31 + 11, "cpu")
    gen = torch.Generator().manual_seed(5)
    seqs = [torch.randint(3, m["vocab"], (n,), generator=gen).tolist()
            for n in (40, 23)]
    positions = [list(range(len(s))) for s in seqs]
    ref = Plain(m).logits(weights, seqs, positions)
    for s, r in zip(seqs, ref):
        with torch.no_grad():
            out, _ = forward(weights, port_cfg, torch.tensor([s]))
        assert (out[0] - r).abs().max() < 1e-4 * r.abs().max()
        assert (out[0].argmax(-1) == r.argmax(-1)).all()
    low = Plain(m, "fp8").logits(weights, seqs, positions)
    mid = Plain(m, "bf16").logits(weights, seqs, positions)
    for r, lo, md in zip(ref, low, mid):
        assert (lo - r).abs().max() > 100 * 1e-4 * r.abs().max()
        assert 0 < (md - r).abs().max() < (lo - r).abs().max()
