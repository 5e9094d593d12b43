"""The MoE FFN's share of its roofline in the profiled slice: for each
`moe.ffn` span (a tick's or an admission round's forwards), the larger
of its routed (token, expert) pairs' 6·hidden·ffn FLOPs over the bf16
peak and each layer call's expert weights read once over the memory
rate, summed, over the spans' device time. In %."""

from perfbench import spans, yardstick


def read(run: dict):
    found = spans.in_slice(run, "moe.ffn")
    if not found:
        return None
    m = run["m"]
    layer_bytes = yardstick.BF16 * 3 * m["hidden"] * m["ffn"] * m["experts"]
    bound = sum(max(
        s["attrs"]["pairs"] * 6.0 * m["hidden"] * m["ffn"]
        / yardstick.PEAK_FLOPS_BF16,
        s["attrs"]["layers"] * layer_bytes / yardstick.PEAK_BYTES_PER_S)
        for s in found)
    device_s = sum(s["attrs"]["device_ms"] for s in found) * 1e-3
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
