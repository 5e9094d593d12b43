"""The benchmark's load generator: MCP `tools/call` traffic over HTTP,
open or closed loop, in a process of its own (standard library only),
so that the client's work is kept off the gateway's interpreter lock.

A copy of `scripts/loadgen.py`'s raw HTTP/1.1 client (one keep-alive
connection per call in flight, responses framed by Content-Length),
extended with an open-loop schedule and per-call records.

Protocol: the parent writes one JSON job line on stdin
({url, tool, seed, vocab, traffic, seconds, extra_s, drain_s,
warmup}); this process sends the warm-up calls and waits for them,
prints {"event": "start", ...} with the schedule's wall-clock marks,
runs the traffic until the window's end plus `extra_s`, waits up to
`drain_s` more for the calls in flight, and prints {"event": "done",
"calls": [...]}. Times are `time.time()`, comparable with the parent's.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

# Neither JAX nor the JAX package may load in a process of a run.
for _name in ("jax", "jaxlib", "flax", "ggrmcp_tpu"):
    sys.modules[_name] = None  # type: ignore[assignment]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from perfbench import traffic  # noqa: E402

# Warm-up calls take indices from here up, clear of the schedule's.
WARMUP_BASE = 10_000_000


class _ClientProtocol(asyncio.Protocol):
    """One keep-alive connection with one call in flight at a time;
    data_received frames the response by Content-Length and resolves
    the waiter with (head, payload)."""

    def __init__(self) -> None:
        self.transport = None
        self.buf = b""
        self.waiter = None
        self.closed = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def connection_lost(self, exc) -> None:
        self.closed = exc or ConnectionResetError("server closed connection")
        if self.waiter is not None and not self.waiter.done():
            self.waiter.set_exception(self.closed)

    def data_received(self, data: bytes) -> None:
        self.buf += data
        if self.waiter is None:
            return
        end = self.buf.find(b"\r\n\r\n")
        if end < 0:
            return
        head = self.buf[:end]
        lower = head.lower()
        idx = lower.find(b"content-length:")
        clen = 0
        if idx >= 0:
            eol = lower.find(b"\r\n", idx)
            clen = int(lower[idx + 15: eol if eol >= 0 else len(lower)])
        total = end + 4 + clen
        if len(self.buf) < total:
            return
        payload = self.buf[end + 4: total]
        self.buf = self.buf[total:]
        waiter, self.waiter = self.waiter, None
        waiter.set_result((head, payload))


def _request(hostport: str, body: bytes, trace: str) -> bytes:
    return (
        b"POST / HTTP/1.1\r\nHost: " + hostport.encode()
        + b"\r\nContent-Type: application/json\r\nX-Trace-Id: "
        + trace.encode() + b"\r\nContent-Length: %d\r\n\r\n" % len(body)
        + body
    )


def parse_response(head: bytes, payload: bytes) -> dict:
    """What a tools/call answered: ok, and the Generate response's token
    ids, finish reason and counts, or the error."""
    if not head.startswith(b"HTTP/1.1 200"):
        return dict(ok=False, err=(head[:40] + b" " + payload[:200]).decode(
            "utf-8", "replace"))
    try:
        data = json.loads(payload)
        result = data["result"]
        if result.get("isError"):
            raise ValueError(json.dumps(result)[:300])
        resp = json.loads(result["content"][0]["text"])
        return dict(ok=True, tokens=[int(t) for t in resp.get("tokenIds", [])],
                    finish=resp.get("finishReason", ""),
                    prompt_tokens=int(resp.get("promptTokens", 0)),
                    completion_tokens=int(resp.get("completionTokens", 0)))
    except (KeyError, IndexError, TypeError, ValueError) as exc:
        return dict(ok=False, err=f"{type(exc).__name__}: {exc}"[:300])


class Client:
    """Connections to the gateway, reused while idle."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.hostport = f"{host}:{port}"
        self.idle: list[_ClientProtocol] = []

    async def call(self, body: bytes, trace: str) -> dict:
        loop = asyncio.get_running_loop()
        proto = None
        while self.idle:
            cand = self.idle.pop()
            if cand.closed is None:
                proto = cand
                break
        if proto is None:
            _, proto = await loop.create_connection(_ClientProtocol,
                                                    self.host, self.port)
        waiter = loop.create_future()
        proto.waiter = waiter
        proto.transport.write(_request(self.hostport, body, trace))
        try:
            head, payload = await waiter
        except BaseException:
            proto.transport.close()
            raise
        self.idle.append(proto)
        return parse_response(head, payload)

    def close(self) -> None:
        for proto in self.idle:
            proto.transport.close()
        self.idle.clear()


async def run(job: dict) -> dict:
    host, port = job["url"].rsplit("//", 1)[-1].rsplit(":", 1)
    client = Client(host, int(port.rstrip("/")))
    spec, seed, vocab = job["traffic"], int(job["seed"]), int(job["vocab"])
    tool = job["tool"]
    records: list[dict] = []

    async def one(index: int, plen: int, max_new: int, due) -> None:
        rec = dict(index=index, due=due, sent=time.time(), done=None,
                   prompt_len=plen, max_new=max_new, ok=False, err="")
        records.append(rec)
        body = traffic.call_body(
            tool, traffic.prompt_ids(seed, index, plen, vocab), max_new, index)
        try:
            rec.update(await client.call(body, traffic.trace_id(seed, index)))
        except (ConnectionError, OSError) as exc:
            rec["err"] = f"{type(exc).__name__}: {exc}"
        rec["done"] = time.time()

    # Warm-up: the listed calls at once, each awaited.
    warm = [one(WARMUP_BASE + k, plen, max_new, None)
            for k, (plen, max_new) in enumerate(job["warmup"])]
    await asyncio.gather(*warm)
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"warm-up call failed: {bad[0]['err']}")
    records.clear()

    t_start = time.time() + 0.05
    w0 = t_start + float(spec["lead_s"])
    w1 = w0 + float(job["seconds"])
    t_end = w1 + float(job["extra_s"])
    deadline = t_end + float(job["drain_s"])
    print(json.dumps(dict(event="start", t_start=t_start, w0=w0, w1=w1,
                          t_end=t_end)), flush=True)
    tasks: list[asyncio.Task] = []
    loop = asyncio.get_running_loop()
    if spec["loop"] == "open":
        stretches = [w0 - t_start, w1 - w0, t_end - w1]
        for c in traffic.open_calls(spec, seed, stretches):
            due = t_start + c["due_s"]
            delay = due - time.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(loop.create_task(
                one(c["index"], c["prompt_len"], c["max_new"], due)))
    else:
        pending = iter(traffic.calls(spec, seed, 1 << 16))

        async def client_loop() -> None:
            while time.time() < t_end:
                c = next(pending)
                await one(c["index"], c["prompt_len"], c["max_new"], None)

        await asyncio.sleep(max(0.0, t_start - time.time()))
        tasks = [loop.create_task(client_loop())
                 for _ in range(int(spec["clients"]))]
    if tasks:
        _, late = await asyncio.wait(tasks,
                                     timeout=max(0.0, deadline - time.time()))
        for task in late:
            task.cancel()
        await asyncio.gather(*late, return_exceptions=True)
    for rec in records:
        if rec["done"] is None and not rec["err"]:
            rec["err"] = "no answer by the drain's deadline"
    client.close()
    return dict(event="done", t_start=t_start, w0=w0, w1=w1, t_end=t_end,
                calls=records)


def main() -> None:
    job = json.loads(sys.stdin.readline())
    print(json.dumps(asyncio.run(run(job))), flush=True)


if __name__ == "__main__":
    main()
