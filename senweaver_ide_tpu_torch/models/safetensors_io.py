"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian u64 header length N, N bytes of JSON,
then the data buffer. The JSON maps each tensor name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (offsets relative to the first
byte after the header) and may hold a ``"__metadata__"`` map of strings,
which the reader skips and the writer does not write (as JAX's export
through ``safetensors.numpy.save_file`` writes none).

The reader maps the file and copies each tensor's bytes once, straight to
its device, as raw bytes reinterpreted as the tensor's dtype: bf16 and
fp8 payloads never pass through a numpy dtype. No tensor it returns
shares memory with the map. The writer pads the header with spaces to a
multiple of 8 and streams each tensor's bytes from a contiguous host
copy, one tensor at a time, into ``path + ".tmp"``, then renames it into
place, so a crash never leaves a torn file under the final name.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
}
_CODES = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"
# a header past this size is a corrupt length field, not a real header
_MAX_HEADER = 100 * 1024 * 1024


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * dtype.itemsize


def read_header(path: str):
    """``(entries, data_start)`` of one file, validated: the
    header lies inside the file, every dtype is known, every shape's bytes
    equal its offsets' span, and the spans tile the data buffer with no
    overlap and no hole."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a "
                             f"safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the "
                             f"file's {size} bytes")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    data_size = size - 8 - n
    spans = []
    for name, e in header.items():
        try:
            dtype = DTYPES[e["dtype"]]
            shape = [int(s) for s in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: bad header entry {name!r}: "
                             f"{e!r}") from None
        if end < begin or _nbytes(dtype, shape) != end - begin:
            raise ValueError(
                f"{path}: {name!r} {e['dtype']}{shape} needs "
                f"{_nbytes(dtype, shape)} bytes, offsets span "
                f"[{begin}, {end})")
        spans.append((begin, end, name))
    spans.sort()
    at = 0
    for begin, end, name in spans:
        if begin != at:
            raise ValueError(
                f"{path}: {name!r} starts at {begin}, expected {at} "
                f"({'overlap' if begin < at else 'hole'} in the data)")
        at = end
    if at != data_size:
        raise ValueError(f"{path}: tensors cover {at} bytes of a "
                         f"{data_size}-byte data buffer")
    return header, 8 + n


class SafetensorsReader:
    """Lazy reader over one or more files: names from the headers, a
    tensor's bytes read only when :meth:`get` asks for it."""

    def __init__(self, paths):
        self._where = {}            # name -> (file index, entry)
        self._maps = []
        try:
            for i, path in enumerate(paths):
                header, start = read_header(path)
                with open(path, "rb") as f:
                    # copy-on-write: writable for torch.frombuffer, and
                    # nothing is ever written through it
                    self._maps.append(
                        (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY),
                         start))
                for name, e in header.items():
                    if name in self._where:
                        raise ValueError(f"tensor {name!r} appears in more "
                                         f"than one file")
                    self._where[name] = (i, e)
        except BaseException:
            self.close()
            raise

    def keys(self):
        return list(self._where)

    def __contains__(self, name) -> bool:
        return name in self._where

    def shape(self, name):
        return tuple(int(s) for s in self._where[name][1]["shape"])

    def get(self, name: str, device="cpu") -> torch.Tensor:
        i, e = self._where[name]
        mm, start = self._maps[i]
        begin, end = (int(o) for o in e["data_offsets"])
        dtype = DTYPES[e["dtype"]]
        shape = [int(s) for s in e["shape"]]
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=device)
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                               offset=start + begin)
        # the one copy: onto the device (or a private host buffer), at
        # offset 0, so the dtype view below is aligned
        raw = (raw.clone() if torch.device(device).type == "cpu"
               else raw.to(device))
        return raw.view(dtype).reshape(shape)

    def close(self) -> None:
        for mm, _ in self._maps:
            mm.close()
        self._maps = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_file(tensors, path: str) -> None:
    """Write ``{name: tensor}`` (any device, any strides) to ``path``."""
    header = {}
    at = 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise TypeError(f"{name!r}: dtype {t.dtype} has no "
                            f"safetensors code")
        n = _nbytes(t.dtype, t.shape)
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    os.replace(tmp, path)


def safetensor_files(model_dir: str):
    """The checkpoint's files: those the sharded index names, else every
    ``*.safetensors`` file in the directory."""
    index = os.path.join(model_dir, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(model_dir, v)
                       for v in weight_map.values()})
    files = sorted(
        os.path.join(model_dir, f) for f in os.listdir(model_dir)
        if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(
            f"no .safetensors files under {model_dir!r} (expected an "
            f"HF-layout checkpoint directory)")
    return files
