"""The plain reference: the published architecture's forward pass in
float32 with TF32 off, layer by layer, over whole sequences, with no
kernel, cache or batching of the program's.

Dense (Mistral): pre-norm blocks, x + Wo·attn(RoPE(norm(x)·Wq), ...),
then x + W_down(silu(norm(x)·W_gate) * norm(x)·W_up); RMSNorm,
x / sqrt(mean(x²) + eps) · w; RoPE on the two halves of each head (the
port's layout of the published rotation); grouped-query attention,
query head h reading key head h // (H / KVH), causal, key j seen by
query i when i - window < j <= i. MoE (Mixtral): the FFN is a softmax
router over the experts, the top-k probabilities renormalised, and
each token's output the weighted sum of its k experts' SwiGLU: every
token routed, none dropped. The logits are the final norm times the
head.

`precision="fp8"` is the control: the same function with every matrix
product's operands rounded to float8 e4m3 (a scale per row of the left
operand and per column of the weight), the step below the
configuration's bf16. `precision="bf16"` is a witness of the
configuration's own precision: every product's operands and the
residual stream rounded to bfloat16, the router a float32 product of
bfloat16 inputs, as the configuration serves it.

Plain `torch` and the benchmark's model module only: nothing of the
program is imported.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
QUERY_BLOCK = 1024


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale per slice along `dim`."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`t` rounded to bfloat16."""
    return t.to(torch.bfloat16).float()


def exact(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return t


ROUNDING = {"fp32": exact, "fp8": fp8, "bf16": bf16}


class Plain:
    """The forward pass at one precision ("fp32", "fp8" or "bf16")."""

    def __init__(self, m: dict, precision: str = "fp32"):
        if precision not in ROUNDING:
            raise ValueError(f"precision {precision!r}")
        self.m = m
        self.round = ROUNDING[precision]
        # The residual stream and the router's input are bfloat16 only
        # in the witness.
        self.stream = bf16 if precision == "bf16" else exact
        # A MoE's routing margin of each sequence's positions: the least,
        # over layers, of the router logit of the k-th expert chosen less
        # that of the best expert left out (how near a tie decided it).
        self.margins: list[torch.Tensor] = []

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.round(x, -1) @ self.round(w, -2)

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.m["norm_eps"]) * w

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, heads, Dh] at positions 0..n-1."""
        n, _, hd = x.shape
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device)
            / hd))
        ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, x: torch.Tensor, lw: dict) -> torch.Tensor:
        m = self.m
        n = x.shape[0]
        h, kvh, hd = m["heads"], m["kv_heads"], m["head_dim"]
        qkv = self.mm(x, lw["wqkv"])
        q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], -1)
        q = self.rope(q.reshape(n, h, hd))
        k = self.rope(k.reshape(n, kvh, hd))
        v = v.reshape(n, kvh, hd)
        k = k.repeat_interleave(h // kvh, 1).transpose(0, 1)  # [h, n, hd]
        v = v.repeat_interleave(h // kvh, 1).transpose(0, 1)
        k, v = self.round(k, -1), self.round(v, -2)
        kpos = torch.arange(n, device=x.device)
        out = torch.empty(n, h, hd, device=x.device)
        for lo in range(0, n, QUERY_BLOCK):
            qb = q[lo: lo + QUERY_BLOCK].transpose(0, 1)  # [h, b, hd]
            qb = self.round(qb, -1)
            s = qb @ k.transpose(1, 2) * hd ** -0.5  # [h, b, n]
            qpos = kpos[lo: lo + QUERY_BLOCK, None]
            seen = kpos[None] <= qpos
            if m["window"]:
                seen &= kpos[None] > qpos - m["window"]
            p = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
            p = self.round(p, -1)
            out[lo: lo + QUERY_BLOCK] = (p @ v).transpose(0, 1)
        return self.mm(out.reshape(n, h * hd), lw["wo"])

    def swiglu(self, x, w_gate, w_up, w_down) -> torch.Tensor:
        gate = torch.nn.functional.silu(self.mm(x, w_gate))
        return self.mm(gate * self.mm(x, w_up), w_down)

    def ffn(self, x: torch.Tensor, lw: dict, seq: int) -> torch.Tensor:
        if self.m["family"] != "moe":
            return self.swiglu(x, lw["w_gate"], lw["w_up"], lw["w_down"])
        k = self.m["experts_per_token"]
        logits = self.stream(x) @ lw["router"]
        top = logits.topk(k + 1, -1).values
        self.margins[seq] = torch.minimum(self.margins[seq],
                                          top[:, k - 1] - top[:, k])
        probs = torch.softmax(logits, -1)
        top_p, top_i = probs.topk(k, -1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(self.m["experts"]):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel():
                y = self.swiglu(x[rows], lw["w_gate"][e], lw["w_up"][e],
                                lw["w_down"][e])
                out.index_add_(0, rows, y * top_p[rows, slot, None])
        return out

    def layer(self, x: torch.Tensor, lw: dict, seq: int) -> torch.Tensor:
        x = self.stream(x + self.attention(self.norm(x, lw["attn_norm"]), lw))
        return self.stream(x + self.ffn(self.norm(x, lw["mlp_norm"]), lw, seq))

    def logits(self, weights: dict, seqs: list[list[int]],
               positions: list[list[int]]) -> list[torch.Tensor]:
        """float32 logits [len(positions[i]), V] of each sequence at its
        positions, one layer's float32 weights in memory at a time; a
        MoE's routing margins at those positions are left in `margins`."""
        dev = weights["embed"].device
        with exact_float32(), torch.no_grad():
            hs = [self.stream(weights["embed"][torch.tensor(s, device=dev)]
                              .float()) for s in seqs]
            self.margins = [torch.full((len(s),), float("inf"), device=dev)
                            for s in seqs]
            layers = weights["layers"]
            for i in range(self.m["layers"]):
                lw = {k: v[i].float() for k, v in layers.items()}
                hs = [self.layer(x, lw, j) for j, x in enumerate(hs)]
                del lw
            head = weights["lm_head"].float()
            fnorm = weights["final_norm"].float()
            at = [torch.tensor(p, device=dev) for p in positions]
            self.margins = [mg[i] for mg, i in zip(self.margins, at)]
            return [self.mm(self.norm(x[i], fnorm), head)
                    for x, i in zip(hs, at)]
