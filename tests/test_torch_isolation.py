"""The PyTorch port stands alone: importing every module of
`ggrmcp_tpu_torch`, and then `chip_smoke` (whose work runs only under
its `__main__` guard), loads neither JAX nor any module of the JAX
package `ggrmcp_tpu`, nor `safetensors`, `tokenizers` or `transformers`
(the machine with the card has none of them; `tokenizers` is imported
only when a tokenizer file is loaded). Checked in a fresh interpreter,
since this test process itself has JAX loaded."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, json, pkgutil, sys
import ggrmcp_tpu_torch
names = sorted(
    m.name for m in pkgutil.walk_packages(
        ggrmcp_tpu_torch.__path__, "ggrmcp_tpu_torch."
    )
)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in (
        "jax", "jaxlib", "ggrmcp_tpu", "safetensors", "tokenizers",
        "transformers",
    )
)
print(json.dumps({"modules": names, "bad": bad}))
"""

# Modules each slice of the port added; all must be walked and imported.
PORT_MODULES = (
    "ggrmcp_tpu_torch.models.bert", "ggrmcp_tpu_torch.models.llama",
    "ggrmcp_tpu_torch.ops.attention", "ggrmcp_tpu_torch.ops.quant",
    "ggrmcp_tpu_torch.serving.engine",
    "ggrmcp_tpu_torch.serving.safetensors_io",
    "ggrmcp_tpu_torch.serving.sidecar", "ggrmcp_tpu_torch.serving.tensors",
    "ggrmcp_tpu_torch.serving.tokenizer", "ggrmcp_tpu_torch.serving.weights",
)


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(PORT_MODULES) <= set(result["modules"]), result["modules"]
    assert len(result["modules"]) >= 25, result  # every module was walked
    assert result["bad"] == [], f"the port loaded {result['bad']}"


def test_port_sources_name_no_jax_import():
    """No source line of the port or of chip_smoke.py imports JAX, the
    JAX package, `safetensors` or `transformers`, even behind a branch
    the import check cannot reach."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ggrmcp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offending = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for n, line in enumerate(fh, 1):
                words = line.split()
                if len(words) >= 2 and words[0] in ("import", "from") and (
                    words[1].split(".")[0] in (
                        "jax", "jaxlib", "ggrmcp_tpu", "safetensors",
                        "transformers",
                    )
                ):
                    offending.append(f"{path}:{n}: {line.strip()}")
    assert not offending, offending
    assert any(p.endswith("safetensors_io.py") for p in paths)
