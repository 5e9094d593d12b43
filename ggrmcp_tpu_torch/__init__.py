"""PyTorch + CUDA port of the ggrmcp_tpu serving plane.

The JAX package `ggrmcp_tpu` is the reference; this package serves the
same `protos/serving.proto` services from PyTorch on one NVIDIA GPU.
Its prefill attention runs through a FlashAttention kernel written by
hand in CUDA C++ for Hopper (`ops/csrc/flash_attention.cu`). Nothing
here imports JAX or the reference package: what it needs from the
reference's JAX-free modules (tokenizer, gRPC helpers, generated
protobuf modules) is copied.

Entry point: `python -m ggrmcp_tpu_torch sidecar --model llama3-8b`.
Everything runs on CUDA unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); a CUDA request on a machine without a
card raises instead of falling back.
"""
