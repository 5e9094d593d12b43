"""The PyTorch port stands alone: importing every module of
`ggrmcp_tpu_torch`, and then `chip_smoke` (whose work runs only under
its `__main__` guard), loads neither JAX nor any module of the JAX
package `ggrmcp_tpu`, nor `safetensors`, `tokenizers`, `transformers`,
`ml_dtypes` or `aiohttp` (`tokenizers` is imported only when a
tokenizer file is loaded; bf16 pages decode through torch,
serving/tensors.py; `aiohttp` belongs to the co-launched gateway, a
child process, and the port speaks HTTP through `urllib` only).
Checked in a fresh interpreter, since this test process itself has JAX
loaded."""

import json
import os
import subprocess
import sys
from tests import torch_threads  # noqa: F401

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
        "transformers", "ml_dtypes", "aiohttp",
    )
)
print(json.dumps({"modules": names, "bad": bad}))
"""

# Modules each slice of the port added; all must be walked and imported.
PORT_MODULES = (
    "ggrmcp_tpu_torch.grammar", "ggrmcp_tpu_torch.grammar.compiler",
    "ggrmcp_tpu_torch.grammar.runtime",
    "ggrmcp_tpu_torch.models.bert", "ggrmcp_tpu_torch.models.llama",
    "ggrmcp_tpu_torch.ops.attention", "ggrmcp_tpu_torch.ops.quant",
    "ggrmcp_tpu_torch.serving.engine", "ggrmcp_tpu_torch.serving.pages",
    "ggrmcp_tpu_torch.serving.safetensors_io",
    "ggrmcp_tpu_torch.serving.sidecar", "ggrmcp_tpu_torch.serving.tensors",
    "ggrmcp_tpu_torch.serving.tokenizer", "ggrmcp_tpu_torch.serving.weights",
    "ggrmcp_tpu_torch.serving.flight_recorder",
    "ggrmcp_tpu_torch.serving.memory_ledger",
    "ggrmcp_tpu_torch.serving.scheduler", "ggrmcp_tpu_torch.serving.slo",
    "ggrmcp_tpu_torch.serving.batching", "ggrmcp_tpu_torch.utils.failpoints",
    "ggrmcp_tpu_torch.utils.tracing", "ggrmcp_tpu_torch.rpc.server_utils",
    "ggrmcp_tpu_torch.serving.host_pool",
    "ggrmcp_tpu_torch.serving.adapter_arena", "ggrmcp_tpu_torch.ops.lora",
    "ggrmcp_tpu_torch.ops.speculative", "ggrmcp_tpu_torch.ops.sampling",
    "ggrmcp_tpu_torch.serving.spec_batcher",
    "ggrmcp_tpu_torch.serving.tiered", "ggrmcp_tpu_torch.models.moe",
    "ggrmcp_tpu_torch.parallel", "ggrmcp_tpu_torch.parallel.mesh",
    "ggrmcp_tpu_torch.parallel.collectives",
    "ggrmcp_tpu_torch.serving.launcher", "ggrmcp_tpu_torch.ops.ring_attention",
    "ggrmcp_tpu_torch.parallel.pipeline",
    "ggrmcp_tpu_torch.models.training", "ggrmcp_tpu_torch.models.trainer",
    "ggrmcp_tpu_torch.serving.checkpoint",
    "ggrmcp_tpu_torch.serving.compile_watcher",
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
    assert len(result["modules"]) >= 40, result  # every module was walked
    assert result["bad"] == [], f"the port loaded {result['bad']}"


def test_port_sources_name_no_jax_import():
    """No source line of the port or of chip_smoke.py imports JAX, the
    JAX package, `safetensors`, `transformers` or `ml_dtypes`, even
    behind a branch the import check cannot reach."""
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
                        "transformers", "ml_dtypes",
                    )
                ):
                    offending.append(f"{path}:{n}: {line.strip()}")
    assert not offending, offending
    assert any(p.endswith("safetensors_io.py") for p in paths)


def test_moe_family_imports_alone_without_jax():
    """The MoE family module and the registry that resolves it, imported
    alone in a fresh interpreter, load no JAX and no module of the JAX
    package."""
    code = (
        "import json, sys\n"
        "from ggrmcp_tpu_torch.models import family_module, get_model, moe\n"
        "assert family_module(get_model('mixtral-8x7b')[1]) is moe\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'ggrmcp_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
