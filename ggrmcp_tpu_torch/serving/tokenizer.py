"""Tokenizers for the sidecar: the hermetic byte-level tokenizer (UTF-8
bytes + specials, no downloaded assets) by default, and a HuggingFace
`tokenizer.json` through the `tokenizers` package when
`serving.tokenizer_path` names one. Copies of `ggrmcp_tpu/serving/
tokenizer.py` (this package imports nothing of the reference);
`tokenizers` is imported only when a tokenizer file is loaded."""

from __future__ import annotations

import codecs
import os


class ByteStreamDecoder:
    """Incremental UTF-8 decode for ByteTokenizer id streams.

    A streaming chunk boundary can split a multi-byte UTF-8 sequence;
    decoding each chunk independently would emit U+FFFD for the
    dangling lead bytes and corrupt the stream irreversibly. This
    buffers an incomplete trailing sequence (codecs' incremental
    decoder) until the bytes that finish it arrive; only `flush()` —
    the end of the stream — turns a genuinely dangling tail into
    replacement characters."""

    def __init__(self, offset: int = 3) -> None:
        self._offset = offset
        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, ids: list[int]) -> str:
        """Decode a chunk of token ids; returns only the text that is
        COMPLETE so far (incomplete trailing bytes stay buffered)."""
        data = bytes(
            i - self._offset for i in ids
            if i >= self._offset and i - self._offset < 256
        )
        return self._decoder.decode(data, False)

    def flush(self) -> str:
        """End of stream: drain the buffer (an incomplete tail decodes
        with replacement characters — the model truly stopped mid-rune)."""
        return self._decoder.decode(b"", True)


class ByteTokenizer:
    """pad=0, bos=1, eos=2; byte b ↦ b + 3. Lossless for any UTF-8."""

    OFFSET = 3

    def __init__(self) -> None:
        self.vocab_size = 256 + self.OFFSET
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2

    def encode(self, text: str) -> list[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if i >= self.OFFSET and i - self.OFFSET < 256
        )
        return data.decode("utf-8", errors="replace")

    def stream_decoder(self) -> ByteStreamDecoder:
        """Per-stream incremental decoder (GenerateStream text_delta
        safety: never emit a split multi-byte sequence as U+FFFD)."""
        return ByteStreamDecoder(self.OFFSET)


class HFStreamDecoder:
    """Incremental decode for HFTokenizer id streams — the
    ByteStreamDecoder contract (never emit a split multi-byte rune as
    U+FFFD mid-stream) for subword vocabularies.

    Llama-3's 128,256-token vocabulary is byte-level BPE: a token can
    END mid-rune (the rest arrives in the next token), so decoding each
    chunk independently would surface replacement characters for text
    that is merely split. Tokens accumulate here and every feed()
    re-decodes the stream, emitting only the STABLE prefix (trailing
    U+FFFD held back as a probably-incomplete sequence); flush() emits
    whatever remains — a genuinely dangling tail decodes with
    replacement characters, exactly like ByteStreamDecoder.flush()."""

    def __init__(self, tok: "HFTokenizer") -> None:
        self._tok = tok
        self._ids: list[int] = []
        self._emitted = 0

    def feed(self, ids: list[int]) -> str:
        self._ids.extend(int(i) for i in ids)
        text = self._tok.decode(self._ids)
        stable = text.rstrip("�")
        if len(stable) < self._emitted:
            return ""
        delta = stable[self._emitted:]
        self._emitted = len(stable)
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta


class HFTokenizer:
    """Wrapper over a local tokenizers-library file (e.g. the Llama-3
    128,256-vocab tokenizer.json via serving.tokenizer_path)."""

    def __init__(self, path: str):
        try:
            from tokenizers import Tokenizer as _Tok
        except ImportError as exc:
            raise ImportError(
                f"tokenizer {path!r} needs the `tokenizers` package, which "
                f"is not installed"
            ) from exc
        self._tok = _Tok.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.pad_id = self._token_id(["<pad>", "[PAD]"], 0)
        self.bos_id = self._token_id(["<s>", "<|begin_of_text|>", "[CLS]"], 1)
        self.eos_id = self._token_id(["</s>", "<|end_of_text|>", "[SEP]"], 2)

    def _token_id(self, candidates: list[str], default: int) -> int:
        for cand in candidates:
            tid = self._tok.token_to_id(cand)
            if tid is not None:
                return tid
        return default

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def stream_decoder(self) -> HFStreamDecoder:
        """Per-stream incremental decoder (GenerateStream text_delta
        safety — same contract as ByteTokenizer.stream_decoder)."""
        return HFStreamDecoder(self)


def load_tokenizer(path: str = ""):
    """"" → the hermetic byte tokenizer; a path loads that HF
    tokenizer.json. A missing file is an error, never a quiet fallback
    to bytes: a sidecar serving byte-level tokens under a config that
    names the Llama-3 tokenizer would mis-tokenize every prompt while
    looking healthy."""
    if not path:
        return ByteTokenizer()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"serving.tokenizer_path {path!r} does not exist "
            f"(set it to a real tokenizer.json or clear it for the "
            f"byte-level tokenizer)"
        )
    return HFTokenizer(path)
