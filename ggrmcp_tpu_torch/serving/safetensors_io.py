"""A safetensors reader written from the format itself (the machine with
the card has no `safetensors` package).

A file is 8 bytes of little-endian u64 header length N, then N bytes of
JSON mapping each tensor name to `{"dtype", "shape", "data_offsets":
[begin, end]}` (byte offsets into the data that follows the header),
plus an optional `"__metadata__"`, then the raw little-endian bytes.

Each read maps just that tensor's bytes copy-on-write
(`mmap.ACCESS_COPY`, so `torch.frombuffer` reads them in place without a
read-only warning), copies the tensor to its device and unmaps them
again: reading a checkpoint tensor by tensor keeps about one tensor's
pages resident on the host. (Dropping the pages of one long-lived map
with `madvise` does not release them under every kernel; unmapping
does.) No numpy on the way: numpy has no bfloat16.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
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
        start = self._base + begin
        lo = start - start % mmap.ALLOCATIONGRANULARITY
        with mmap.mmap(self._fh.fileno(), self._base + end - lo, offset=lo,
                       access=mmap.ACCESS_COPY) as mm:
            view = torch.frombuffer(
                mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
                offset=start - lo,
            ).view(e["shape"])
            out = view.to(device, copy=True)
            del view  # releases the buffer export, so the map can close
        return out

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

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
