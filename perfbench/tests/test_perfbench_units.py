"""The benchmark's yardstick on the CPU: traffic drawn from the seed,
percentiles over every call from its due time, and the bound and FLOP
arithmetic against counts made by hand."""

import json
import math
from pathlib import Path

import pytest

from perfbench import model, records, traffic, yardstick

HERE = Path(__file__).resolve().parents[1]
OPEN = traffic.load(HERE / "workloads" / "agent-open.json")
CLOSED = traffic.load(HERE / "workloads" / "docs-closed.json")


@pytest.mark.parametrize("spec", [OPEN, CLOSED], ids=["open", "closed"])
def test_calls_are_the_seeds(spec):
    a = traffic.calls(spec, 2**31 + 5, 300)
    assert a == traffic.calls(spec, 2**31 + 5, 300)
    assert a != traffic.calls(spec, 2**31 + 6, 300)
    lo, hi = spec["prompt_tokens"]["min"], spec["prompt_tokens"]["max"]
    assert all(lo <= c["prompt_len"] <= hi for c in a)
    lo, hi = spec["output_tokens"]["min"], spec["output_tokens"]["max"]
    assert all(lo <= c["max_new"] <= hi for c in a)


@pytest.mark.parametrize("spec", [OPEN, CLOSED], ids=["open", "closed"])
@pytest.mark.parametrize("key", ["prompt_len", "max_new"])
def test_every_seed_offers_the_same_work(spec, key):
    """Each block of calls holds the same lengths, in another order."""
    block = traffic.BLOCK
    n = 4 * block
    a = [c[key] for c in traffic.calls(spec, 1, n)]
    b = [c[key] for c in traffic.calls(spec, 2, n)]
    assert a != b and sorted(a) == sorted(b)
    for i in range(0, n, block):
        assert sorted(a[i:i + block]) == sorted(b[i:i + block])


def test_open_loop_arrives_at_its_rate():
    """Poisson arrivals given their count: round(rate x length) in each
    stretch, placed uniformly, so gaps are exponential in law (bursts
    and lulls), and every seed has as many calls due in the window."""
    rate = OPEN["rate_per_s"]
    stretches = [10.0, 500.0, 2.5]
    due = traffic.arrivals(OPEN, 2**31 + 7, stretches)
    assert due == sorted(due)
    edges = [0.0, 10.0, 510.0, 512.5]
    for (lo, hi), length in zip(zip(edges, edges[1:]), stretches):
        assert sum(lo <= t < hi for t in due) == round(rate * length)
    window = [t for t in due if 10.0 <= t < 510.0]
    gaps = [b - a for a, b in zip(window, window[1:])]
    mean = sum(gaps) / len(gaps)
    assert mean == pytest.approx(1 / rate, rel=0.02)
    sd = math.sqrt(sum((g - mean) ** 2 for g in gaps) / len(gaps))
    assert sd == pytest.approx(mean, rel=0.15)  # exponential: sd = mean
    assert max(gaps) > 5 * mean and min(gaps) < 0.01 * mean
    calls = traffic.open_calls(OPEN, 2**31 + 7, stretches)
    assert [c["due_s"] for c in calls] == due
    assert calls != traffic.open_calls(OPEN, 2**31 + 8, stretches)
    assert len(traffic.arrivals(OPEN, 2**31 + 8, stretches)) == len(due)


def test_prompts_are_the_seeds():
    ids = traffic.prompt_ids(2**31 + 9, 4, 100, 32000)
    assert ids == traffic.prompt_ids(2**31 + 9, 4, 100, 32000)
    assert ids != traffic.prompt_ids(2**31 + 9, 5, 100, 32000)
    assert ids[0] == traffic.BOS and len(ids) == 100
    assert all(traffic.FIRST_ID <= t < 32000 for t in ids[1:])
    body = json.loads(traffic.call_body("tool", ids, 7, 4))
    args = body["params"]["arguments"]
    assert args["promptIds"]["intValues"] == ids
    assert args["maxNewTokens"] == 7 and args["returnTokens"] is True


def _run(calls, loop="open"):
    return dict(calls=calls, w0=100.0, w1=110.0, seconds=10.0, loop=loop,
                given_up=200.0)


def test_latency_is_from_due_time_over_every_call():
    calls = [dict(index=i, due=100.0 + i, sent=100.5 + i, done=101.0 + i,
                  ok=True) for i in range(10)]
    calls[3].update(ok=False, done=None)  # never answered
    calls.append(dict(index=99, due=99.0, sent=99.0, done=100.5, ok=True))
    run = _run(calls)
    due = records.due_in_window(run)
    assert len(due) == 10  # the call due before the window is out
    ms = sorted(records.call_ms(run, c) for c in due)
    assert ms[:9] == [1000.0] * 9  # due to done, not sent to done
    assert ms[9] == pytest.approx((200.0 - 103.0) * 1e3)
    assert yardstick.nearest_rank(ms, 0.5) == 1000.0
    assert yardstick.nearest_rank(ms, 0.95) == ms[9]


def test_closed_loop_counts_calls_sent_in_the_window():
    calls = [dict(index=0, due=None, sent=99.0, done=101.0, ok=True),
             dict(index=1, due=None, sent=101.0, done=111.0, ok=True)]
    run = _run(calls, "closed")
    assert [c["index"] for c in records.due_in_window(run)] == [1]
    assert [c["index"] for c in records.done_in_window(run)] == [0]


MISTRAL = model.shape(json.loads(
    (HERE / "configs" / "mistral-7b.json").read_text()))
MIXTRAL = model.shape(json.loads(
    (HERE / "configs" / "mixtral-8x7b-16l.json").read_text()))


def test_causal_pairs_by_hand():
    assert yardstick.causal_pairs(4, None) == 10  # 1 + 2 + 3 + 4
    assert yardstick.causal_pairs(4, 4) == 10
    assert yardstick.causal_pairs(5, 2) == 1 + 2 + 2 + 2 + 2


def test_attention_bound_by_hand():
    n = 2048
    flops, nbytes = yardstick.prompt_attention(MISTRAL, n)
    assert flops == 4 * 128 * 32 * (n * (n + 1) // 2) * 32
    # Q and O: 32 heads, K and V: 8 heads; 128 wide, bf16, 32 layers.
    assert nbytes == 2 * n * 128 * 32 * (2 * 32 + 2 * 8)
    assert yardstick.attention_bound_s(MISTRAL, n) == pytest.approx(
        flops / 989e12)  # bound by operations at this length


def test_flops_by_hand():
    # Mistral-7B: 7.24e9 weights, of which 2 x 131M embedding and head;
    # the embedding is a lookup.
    per_token = yardstick.dense_flops_per_token(MISTRAL)
    layer = 4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336
    assert per_token == 2 * (32 * layer + 4096 * 32000)
    assert 2 * 7.0e9 < per_token < 2 * 7.2e9
    # Mixtral at 16 layers: two experts a token and the router.
    moe = yardstick.dense_flops_per_token(MIXTRAL)
    layer = 4096 * 6144 + 4096 * 4096 + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert moe == 2 * (16 * layer + 4096 * 32000)
    assert yardstick.token_flops(MISTRAL, 9) == per_token + 4 * 10 * 32 * 128 * 32
    assert yardstick.prompt_flops(MISTRAL, 3) == 3 * per_token + (
        4 * 6 * 32 * 128 * 32)


def test_decode_bytes_by_hand():
    w = yardstick.weight_bytes_read_per_tick(MIXTRAL, 32)
    layer = 4096 * 6144 + 4096 * 4096 + 8 * 3 * 4096 * 14336 + 2 * 4096
    assert w == 2 * (16 * layer + 4096 + 4096 * 32000 + 32 * 4096) + (
        4 * 16 * 4096 * 8)
    assert 46.6e9 < w < 46.8e9  # every weight but the embedding table
    assert yardstick.kv_bytes(MISTRAL, 100) == 2 * 2 * 100 * 8 * 128 * 32
    # The window caps what a row reads.
    assert yardstick.kv_bytes(MISTRAL, 5000) == yardstick.kv_bytes(
        MISTRAL, 4096)


def test_weights_are_the_seeds():
    tiny = dict(MISTRAL, hidden=32, layers=2, heads=4, kv_heads=2,
                head_dim=8, ffn=48, vocab=64, dtype="float32")
    a = model.make_weights(tiny, 2**31 + 3, "cpu")
    b = model.make_weights(tiny, 2**31 + 3, "cpu")
    c = model.make_weights(tiny, 2**31 + 4, "cpu")
    assert set(a) == {"embed", "layers", "final_norm", "lm_head"}
    assert a["layers"]["wqkv"].shape == (2, 32, (4 + 2 * 2) * 8)
    for k in ("embed", "lm_head"):
        assert (a[k] == b[k]).all() and not (a[k] == c[k]).all()
