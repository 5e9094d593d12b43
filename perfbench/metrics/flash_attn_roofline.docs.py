"""The attention kernel's share of its roofline in the profiled slice:
the least time of the attention its admitted prompts need (the larger
of 4·Dh FLOPs a causal (query head, key) pair over the bf16 peak and
each Q, O, K and V byte once over the memory rate), over the device
time of exactly those admissions' kernel launches. Nothing when the
slice holds no whole admission or the kernels found do not match the
launches counted. In %."""

from perfbench import devtrace, yardstick


def read(run: dict):
    trace = run.get("trace")
    if not trace:
        return None
    adm = [a for a in trace["admissions"] if a["launches"]]
    launches = sum(a["launches"] for a in adm)
    b1 = [d for n, _, d in trace["kernels"] if devtrace.B1_KERNEL.search(n)]
    if not launches or len(b1) != launches:
        return None
    bound = sum(yardstick.attention_bound_s(run["m"], n)
                for a in adm for n in a["lens"])
    return 100.0 * bound / sum(b1)
