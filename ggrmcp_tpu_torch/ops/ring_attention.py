"""Sequence parallelism: ring attention and Ulysses all-to-all.

Port of `ggrmcp_tpu/ops/ring_attention.py` over the single-controller
mesh (parallel/mesh.py). Both take whole [B, S, H, D] tensors, split the
sequence over the mesh's `sequence` axis (shard i holds positions
[i·S/n, (i+1)·S/n) on its coordinate's device), run the scheme with the
explicit collectives of parallel/collectives.py and return the whole
output on q's device. `coord` fixes the other axes' indices (a tensor
shard's heads run on that shard's sequence ring). These are torch ops,
not a kernel, as the reference's are XLA ops:

- **Ring**: queries stay put; K/V blocks rotate around the ring
  (`ppermute`) while each shard accumulates its queries' attention with
  a float32 online softmax. Causal and sliding-window masks use GLOBAL
  positions, so they compose with the rotation exactly.
- **Ulysses**: `all_to_all` re-shards [B, S/n, H, D] → [B, S, H/n, D]
  (the sequence gathered, the heads scattered), plain attention runs on
  the full sequence (`attention_ref`, the reference's XLA path), and the
  layout is scattered back.

Both are plain attention when the axis has size 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from ggrmcp_tpu_torch.ops.attention import NEG_INF, attention_ref
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import all_gather, all_to_all, ppermute


def _sequence_devices(mesh: mesh_mod.Mesh,
                  coord: Optional[dict]) -> list[torch.device]:
    """The devices of the sequence shards at `coord` on the other axes."""
    return [mesh.devices[mesh.index(**{**(coord or {}), "sequence": i})]
            for i in range(mesh.shape["sequence"])]


def _split(x: torch.Tensor, devs: list, dim: int = 1) -> list[torch.Tensor]:
    return [blk.to(d, non_blocking=True)
            for blk, d in zip(x.chunk(len(devs), dim=dim), devs)]


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None and not causal:
        raise ValueError("sliding window requires causal")


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: mesh_mod.Mesh,
    causal: bool = True,
    window: Optional[int] = None,
    coord: Optional[dict] = None,
) -> torch.Tensor:
    _check_window(causal, window)
    n = mesh.shape["sequence"]
    if n <= 1:
        return attention_ref(q, k, v, causal=causal, window=window)
    s = q.shape[1]
    if s % n != 0:
        raise ValueError(
            f"sequence length {s} not divisible by sequence axis {n}")
    devs = _sequence_devices(mesh, coord)
    qs, ks, vs = _split(q, devs), _split(k, devs), _split(v, devs)
    b, sl, h, d = qs[0].shape
    scale = d ** -0.5
    state = []
    for i, qi in enumerate(qs):
        dev = qi.device
        state.append(dict(
            q=qi.float() * scale,
            q_pos=i * sl + torch.arange(sl, device=dev),
            m=torch.full((b, h, sl, 1), NEG_INF, dtype=torch.float32,
                         device=dev),
            l=torch.zeros((b, h, sl, 1), dtype=torch.float32, device=dev),
            acc=torch.zeros((b, sl, h, d), dtype=torch.float32, device=dev)))
    for step in range(n):
        for i, st in enumerate(state):
            # After `step` rotations shard i holds the block that started
            # at shard (i - step) mod n.
            src = (i - step) % n
            dev = st["q"].device
            k_pos = src * sl + torch.arange(sl, device=dev)
            scores = torch.einsum("bqhd,bkhd->bhqk", st["q"],
                                  ks[i].float())
            if causal:
                mask = st["q_pos"][:, None] >= k_pos[None, :]
                if window is not None:
                    mask &= (st["q_pos"][:, None] - k_pos[None, :]) < window
                scores = torch.where(mask[None, None], scores,
                                     torch.full_like(scores, NEG_INF))
            m_new = torch.maximum(st["m"], scores.amax(dim=-1, keepdim=True))
            alpha = torch.exp(st["m"] - m_new)
            p = torch.exp(scores - m_new)
            st["l"] = st["l"] * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, vs[i].float())
            st["acc"] = st["acc"] * alpha.transpose(1, 2) + pv
            st["m"] = m_new
        if step < n - 1:  # the n-th rotation would bring them home
            ks, vs = ppermute(ks), ppermute(vs)
    outs = [(st["acc"] / torch.clamp(st["l"], min=1e-30).transpose(1, 2))
            .to(q.dtype) for st in state]
    return all_gather(outs, dim=1).to(q.device)


def ulysses_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: mesh_mod.Mesh,
    causal: bool = True,
    window: Optional[int] = None,
    coord: Optional[dict] = None,
) -> torch.Tensor:
    _check_window(causal, window)
    n = mesh.shape["sequence"]
    if n <= 1:
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"head count {q.shape[2]} not divisible by sequence={n}")
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence {q.shape[1]} not divisible by sequence={n}")
    devs = _sequence_devices(mesh, coord)
    # [B, S/n, H, D] per shard → [B, S, H/n, D]: gather the sequence,
    # scatter the heads. Full sequences are local after it, so the
    # ordinary (windowed) causal mask applies unchanged.
    qh, kh, vh = (all_to_all(_split(x, devs), split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    outs = [attention_ref(a, b, c, causal=causal, window=window)
            for a, b, c in zip(qh, kh, vh)]
    back = all_to_all(outs, split_dim=1, concat_dim=2)
    return all_gather(back, dim=1).to(q.device)
