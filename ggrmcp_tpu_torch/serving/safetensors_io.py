"""A safetensors reader and writer written from the format itself (the
machine with the card has no `safetensors` package).

A file is 8 bytes of little-endian u64 header length N, then N bytes of
JSON mapping each tensor name to `{"dtype", "shape", "data_offsets":
[begin, end]}` (byte offsets into the data that follows the header),
plus an optional `"__metadata__"`, then the raw little-endian bytes.

`read_window` reads a [rows, cols] window of a 2-D tensor for a mesh
shard (serving/weights.py `load_hf_checkpoint_sharded`): a row range
as one contiguous mapping, a column range row block by row block, so
the host never maps the whole tensor.

Each read maps just that tensor's bytes copy-on-write
(`mmap.ACCESS_COPY`, so `torch.frombuffer` reads them in place without a
read-only warning), copies the tensor to its device and unmaps them
again: reading a checkpoint tensor by tensor keeps about one tensor's
pages resident on the host. (Dropping the pages of one long-lived map
with `madvise` does not release them under every kernel; unmapping
does.) No numpy on the way: numpy has no bfloat16.

`write_file` writes a file of this format (the port's own checkpoints,
serving/checkpoint.py): bf16 as its raw 16-bit words, each tensor
copied to the host and written in turn, so the host holds one tensor at
a time.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}
INDEX = "model.safetensors.index.json"


def _check_entry(path: str, name: str, e: dict, data_bytes: int) -> None:
    if e["dtype"] not in _DTYPES:
        raise ValueError(
            f"{path}: {name} has dtype {e['dtype']}; this reader takes "
            f"{sorted(_DTYPES)}"
        )
    begin, end = e["data_offsets"]
    numel = 1
    for dim in e["shape"]:
        numel *= dim
    if not 0 <= begin <= end <= data_bytes or (
        end - begin != numel * _DTYPES[e["dtype"]].itemsize
    ):
        raise ValueError(f"{path}: bad data_offsets for {name}")


def write_file(path: str, tensors: dict, metadata: dict | None = None) -> int:
    """Write `tensors` (name -> tensor on any device, of a dtype in
    `_DTYPES`) to one safetensors file at `path`, in the dict's order,
    with string `metadata` under `__metadata__`. Returns the data bytes
    written."""
    header: dict = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name here ({sorted(_DTYPES)})")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                fh.write(host.reshape(-1).view(torch.uint8).numpy().data)
    return offset


class SafetensorsFile:
    """One open `.safetensors` file; `entries` is its header without
    `__metadata__`. Close it (or use `with`)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        try:
            head = self._fh.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(self._fh.fileno()).st_size
            if 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes past the end")
            header = json.loads(self._fh.read(n))
            header.pop("__metadata__", None)
            self._base = 8 + n
            for name, e in header.items():
                _check_entry(path, name, e, size - self._base)
        except BaseException:
            self._fh.close()
            raise
        self.entries: dict[str, dict] = header

    def read(self, name: str, device) -> torch.Tensor:
        """Tensor `name` in its stored dtype, copied to `device` (a copy
        on the CPU too, so it outlives the map)."""
        e = self.entries[name]
        dtype = _DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(e["shape"], dtype=dtype, device=device)
        return self._read_span(begin, end, dtype, e["shape"],
                               lambda view: view.to(device, copy=True))

    def _read_span(self, begin: int, end: int, dtype, shape, take):
        """Map data bytes [begin, end) copy-on-write, view them as
        `shape`, return `take(view)` (which must copy) and unmap."""
        start = self._base + begin
        lo = start - start % mmap.ALLOCATIONGRANULARITY
        with mmap.mmap(self._fh.fileno(), self._base + end - lo, offset=lo,
                       access=mmap.ACCESS_COPY) as mm:
            view = torch.frombuffer(
                mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
                offset=start - lo,
            ).view(shape)
            out = take(view)
            del view  # releases the buffer export, so the map can close
        return out

    def read_window(self, name: str, rows: slice, cols: slice, out,
                    block_bytes: int = 64 << 20) -> int:
        """Copy window [rows, cols] of 2-D tensor `name` (a 1-D one reads
        as one row) into `out` (a tensor of the window's shape, any dtype
        and device, the cast done by `copy_`). Whole rows are one
        mapping; a column window maps blocks of whole rows of about
        `block_bytes` each. Returns the bytes mapped."""
        e = self.entries[name]
        dtype = _DTYPES[e["dtype"]]
        n_rows, n_cols = ([1] + e["shape"])[-2:]
        r0, r1, _ = rows.indices(n_rows)
        c0, c1, _ = cols.indices(n_cols)
        row_bytes = n_cols * dtype.itemsize
        begin = e["data_offsets"][0]
        if tuple(out.shape) != (r1 - r0, c1 - c0):
            # Checked before anything is mapped: a failing copy would
            # leave a traceback holding a view of the unmapped bytes.
            raise ValueError(
                f"{name}: window [{r0}:{r1}, {c0}:{c1}] into a tensor of "
                f"shape {tuple(out.shape)}")
        if r1 <= r0 or c1 <= c0:
            return 0
        step = r1 - r0 if (c0, c1) == (0, n_cols) else max(
            1, block_bytes // row_bytes)
        for a in range(r0, r1, step):
            b = min(a + step, r1)
            self._read_span(
                begin + a * row_bytes, begin + b * row_bytes, dtype,
                (b - a, n_cols),
                lambda view, a=a, b=b: out[a - r0:b - r0].copy_(
                    view[:, c0:c1]),
            )
        return (r1 - r0) * row_bytes

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Checkpoint:
    """The tensors of a checkpoint directory: the files named by
    `model.safetensors.index.json`'s `weight_map`, or else every
    `*.safetensors` file in it."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX)
        weight_map = None
        if os.path.exists(index):
            with open(index) as fh:
                weight_map = json.load(fh)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(
                f for f in os.listdir(path) if f.endswith(".safetensors")
            )
            if not files:
                raise FileNotFoundError(f"no .safetensors files under {path}")
        self._files: dict[str, SafetensorsFile] = {}
        try:
            for fname in files:
                self._files[fname] = SafetensorsFile(os.path.join(path, fname))
        except BaseException:
            self.close()
            raise
        if weight_map is None:
            weight_map = {
                name: fname for fname, f in self._files.items()
                for name in f.entries
            }
        self.weight_map: dict[str, str] = weight_map

    @property
    def names(self) -> set[str]:
        return set(self.weight_map)

    def read(self, name: str, device) -> torch.Tensor:
        return self._files[self.weight_map[name]].read(name, device)

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._files[self.weight_map[name]].entries[name]["shape"])

    def read_window(self, name: str, rows: slice, cols: slice, out) -> int:
        return self._files[self.weight_map[name]].read_window(
            name, rows, cols, out)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
