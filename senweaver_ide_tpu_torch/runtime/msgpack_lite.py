"""Minimal msgpack codec for the control-plane RPC.

The reference CLI speaks both JSON-RPC and msgpack-RPC to its server
(cli/src/json_rpc.rs, cli/src/msgpack_rpc.rs — SURVEY.md §2.6/L10). This
is the msgpack half for the trainer's control plane: a dependency-free
subset codec covering exactly the types RPC envelopes use — nil, bool,
ints, float64, str, bin, array, map.

Wire-format subset (msgpack spec):
  nil 0xc0 | false 0xc2 | true 0xc3 | float64 0xcb
  positive fixint 0x00-0x7f | negative fixint 0xe0-0xff
  uint8/16/32/64 0xcc-0xcf | int8/16/32/64 0xd0-0xd3
  fixstr 0xa0-0xbf | str8/16/32 0xd9-0xdb | bin8/16/32 0xc4-0xc6
  fixarray 0x90-0x9f | array16/32 0xdc-0xdd
  fixmap 0x80-0x8f | map16/32 0xde-0xdf
"""

from __future__ import annotations

import struct
from typing import Any, Tuple


def pack(obj: Any) -> bytes:
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


def _pack_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += bytes((0xD9, n))
        elif n < 0x10000:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 0x100:
            out += bytes((0xC4, n))
        elif n < 0x10000:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += bytes(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 0x100:
        out += bytes((0xCC, v))
    elif 0 <= v < 0x10000:
        out.append(0xCD)
        out += struct.pack(">H", v)
    elif 0 <= v < 0x100000000:
        out.append(0xCE)
        out += struct.pack(">I", v)
    elif v >= 0:
        out.append(0xCF)
        out += struct.pack(">Q", v)
    elif v >= -0x80:
        out.append(0xD0)
        out += struct.pack(">b", v)
    elif v >= -0x8000:
        out.append(0xD1)
        out += struct.pack(">h", v)
    elif v >= -0x80000000:
        out.append(0xD2)
        out += struct.pack(">i", v)
    else:
        out.append(0xD3)
        out += struct.pack(">q", v)


MAX_DEPTH = 64     # far beyond any RPC envelope; a ~1 KB payload of
                   # nested fixarray headers must raise ValueError (which
                   # the server's framing probe handles), NOT RecursionError


def unpack(data: bytes) -> Any:
    """Decode one msgpack value; trailing bytes are an error."""
    obj, off = _unpack_from(data, 0)
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing bytes after value")
    return obj


def unpack_prefix(data: bytes) -> Tuple[Any, int]:
    """Decode one value from the head of ``data``; returns (value, end)."""
    return _unpack_from(data, 0)


def _unpack_from(data: bytes, off: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise ValueError(f"nesting exceeds MAX_DEPTH={MAX_DEPTH}")
    if off >= len(data):
        raise ValueError("truncated msgpack data")
    b = data[off]
    off += 1
    if b <= 0x7F:                           # positive fixint
        return b, off
    if b >= 0xE0:                           # negative fixint
        return b - 0x100, off
    if 0x80 <= b <= 0x8F:                   # fixmap
        return _unpack_map(data, off, b & 0x0F, depth)
    if 0x90 <= b <= 0x9F:                   # fixarray
        return _unpack_array(data, off, b & 0x0F, depth)
    if 0xA0 <= b <= 0xBF:                   # fixstr
        return _take_str(data, off, b & 0x1F)
    if b == 0xC0:
        return None, off
    if b == 0xC2:
        return False, off
    if b == 0xC3:
        return True, off
    if b in (0xC4, 0xC5, 0xC6):             # bin8/16/32
        n, off = _take_len(data, off, (1, 2, 4)[b - 0xC4])
        _need(data, off, n)
        return bytes(data[off:off + n]), off + n
    if b == 0xCB:                           # float64
        _need(data, off, 8)
        return struct.unpack_from(">d", data, off)[0], off + 8
    if b == 0xCA:                           # float32
        _need(data, off, 4)
        return struct.unpack_from(">f", data, off)[0], off + 4
    if b in (0xCC, 0xCD, 0xCE, 0xCF):       # uint8/16/32/64
        size = 1 << (b - 0xCC)
        _need(data, off, size)
        return int.from_bytes(data[off:off + size], "big"), off + size
    if b in (0xD0, 0xD1, 0xD2, 0xD3):       # int8/16/32/64
        size = 1 << (b - 0xD0)
        _need(data, off, size)
        return int.from_bytes(data[off:off + size], "big",
                              signed=True), off + size
    if b in (0xD9, 0xDA, 0xDB):             # str8/16/32
        n, off = _take_len(data, off, (1, 2, 4)[b - 0xD9])
        return _take_str(data, off, n)
    if b in (0xDC, 0xDD):                   # array16/32
        n, off = _take_len(data, off, (2, 4)[b - 0xDC])
        return _unpack_array(data, off, n, depth)
    if b in (0xDE, 0xDF):                   # map16/32
        n, off = _take_len(data, off, (2, 4)[b - 0xDE])
        return _unpack_map(data, off, n, depth)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _need(data: bytes, off: int, n: int) -> None:
    if off + n > len(data):
        raise ValueError("truncated msgpack data")


def _take_len(data: bytes, off: int, size: int) -> Tuple[int, int]:
    _need(data, off, size)
    return int.from_bytes(data[off:off + size], "big"), off + size


def _take_str(data: bytes, off: int, n: int) -> Tuple[str, int]:
    _need(data, off, n)
    return data[off:off + n].decode("utf-8", errors="replace"), off + n


def _unpack_array(data: bytes, off: int, n: int,
                  depth: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, off = _unpack_from(data, off, depth + 1)
        out.append(item)
    return out, off


def _unpack_map(data: bytes, off: int, n: int,
                depth: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, off = _unpack_from(data, off, depth + 1)
        v, off = _unpack_from(data, off, depth + 1)
        out[k] = v
    return out, off


def is_msgpack_request(first_byte: int) -> bool:
    """RPC requests are maps: fixmap / map16 / map32 lead bytes. JSON
    requests start with '{' (0x7b, a positive fixint in msgpack) so the
    two framings are unambiguous at byte 0."""
    return (0x80 <= first_byte <= 0x8F) or first_byte in (0xDE, 0xDF)
