"""Hermetic byte-level tokenizer: UTF-8 bytes + specials, no
downloaded assets. A copy of `ByteTokenizer` and `ByteStreamDecoder`
from `ggrmcp_tpu/serving/tokenizer.py` (this package imports nothing of
the reference)."""

from __future__ import annotations

import codecs


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
