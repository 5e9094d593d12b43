"""The decode ticks' share of their bytes bound: for each tick of the
window, the weights read once plus each live row's K and V up to its
length, at the card's memory rate, summed, over the ticks' decode time
(duration less admit phase), summed. In %."""

from perfbench import records, yardstick


def read(run: dict):
    m, by = run["m"], records.requests_by_trace(run)
    bound = spent = 0.0
    for t in records.window_ticks(run):
        lens = records.live_lengths(run, t, by)
        if not lens:
            continue
        nbytes = yardstick.weight_bytes_read_per_tick(m, len(lens)) + sum(
            yardstick.kv_bytes(m, n) for n in lens)
        bound += nbytes / yardstick.PEAK_BYTES_PER_S
        spent += (t["duration_ms"] - t["phase_admit_ms"]) * 1e-3
    return 100.0 * bound / spent if spent > 0 else None
