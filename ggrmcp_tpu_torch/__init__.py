"""PyTorch + CUDA port of the ggrmcp_tpu serving plane.

The JAX package `ggrmcp_tpu` is the reference; this package serves the
same `protos/serving.proto` services from PyTorch on one NVIDIA GPU.
Its prefill attention runs through a FlashAttention kernel written by
hand in CUDA C++ for Hopper (`ops/csrc/flash_attention.cu`). Nothing
here imports JAX or the reference package: what it needs from the
reference's JAX-free modules (tokenizer, gRPC helpers, generated
protobuf modules) is copied.

Entry points: `python -m ggrmcp_tpu_torch gateway --tpu --model
llama3-8b` (the MCP gateway and the sidecar in one process), `gateway
--backend HOST:PORT` (the gateway alone) and `sidecar`. Everything runs
on CUDA unless the caller asks for the CPU (`device="cpu"`, `--device
cpu`); a CUDA request on a machine without a card raises instead of
falling back.
"""

# The installed distribution's version, which MCP `initialize` reports
# (config.MCPConfig.server_version); the literal covers a bare checkout.
try:  # pragma: no cover - depends on install state
    from importlib.metadata import PackageNotFoundError, version

    __version__ = version("ggrmcp-tpu")
except PackageNotFoundError:  # checkout without `pip install -e .`
    __version__ = "0.5.0"
except Exception:  # pragma: no cover - metadata backend quirks
    __version__ = "0.5.0"
