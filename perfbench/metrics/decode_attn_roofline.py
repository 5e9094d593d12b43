"""Decode attention's share of its bytes bound in the profiled slice:
each tick's live rows' K and V up to their cached lengths (the
`attn.decode` spans' lengths, the batcher's host state) at the card's
memory rate, over the spans' device time (`attention_ref` at
decode-shaped queries, every layer). In %."""

from perfbench import spans, yardstick


def read(run: dict):
    found = spans.in_slice(run, "attn.decode")
    if not found:
        return None
    m = run["m"]
    nbytes = sum(yardstick.kv_bytes(m, n) * s["attrs"]["layers"] / m["layers"]
                 for s in found for n in s["attrs"]["lengths"])
    device_s = sum(s["attrs"]["device_ms"] for s in found) * 1e-3
    if device_s <= 0:
        return None
    return 100.0 * nbytes / yardstick.PEAK_BYTES_PER_S / device_s
