"""Structured JSON logging: one JSON object per line, carrying the
current trace id from the tracing contextvar (utils/tracing.py).

Opt-in via `logging.format: json` in the config tree or the config-free
`GGRMCP_LOG_JSON=1` env var (gateway/app.py::setup_logging wires both;
the sidecar's run() goes through the same function). The legacy
format-string modes are untouched — they interpolate the message into a
JSON-shaped template but never escape it, so they are greppable, not
parseable. This formatter is the parseable one: every record is
json.dumps'd, and a record emitted inside a request span carries that
span's trace id — which is what lets a log line join the span ring
(/debug/traces), the flight-recorder rings (/debug/requests,
/debug/ticks), and the unified timeline (/debug/timeline) on one key.
"""

from __future__ import annotations

import json
import logging

from ggrmcp_tpu_torch.utils import tracing


class JsonFormatter(logging.Formatter):
    """One JSON object per record: ts (epoch seconds), level, logger,
    msg, trace_id (when inside a span), exc (formatted traceback when
    the record carries one). Non-serializable extras degrade to str
    rather than raising — a log call must never throw."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = tracing.tracer.current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False, default=str)
