"""A small MessagePack encoder and decoder.

The reference writes `updaterState.bin` with flax's msgpack serializer,
and the port may import neither flax nor the `msgpack` package. This
module covers what that format uses: maps, arrays, str, bin, ints,
floats, nil, booleans and ext types. It encodes canonically (the shortest
form of each int, str, bin, map, array and ext header, as the `msgpack`
package does with ``use_bin_type=True``), so equal data gives equal
bytes.

    packb(obj, default=None) -> bytes
    unpackb(data, ext_hook=None) -> obj

`default(obj)` may return an `ExtType` for objects the encoder does not
know; `ext_hook(code, data)` turns an ext payload back into an object
(without one, the `ExtType` is returned as it is). Tuples encode as
arrays and arrays decode as lists.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional


class ExtType(NamedTuple):
    code: int
    data: bytes


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int,
              codes: tuple):
    """A length header: fixed form below fix_max, else 8/16/32-bit (codes
    for the widths available, None where a width does not exist)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out: bytearray, default):
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
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, ExtType):
        _pack_ext(obj, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, default)
            _pack(v, out, default)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out, default)
    elif default is not None:
        ext = default(obj)
        if ext is obj:
            raise TypeError(f"msgpack: cannot serialize {type(obj)}")
        _pack(ext, out, None)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj)}")


def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if n >= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too small")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(ext: ExtType, out: bytearray):
    n = len(ext.data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", ext.code)
    out += ext.data


def unpackb(data: bytes, ext_hook: Optional[Callable] = None) -> Any:
    reader = _Reader(bytes(data), ext_hook)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "of trailing data")
    return obj


class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.data = data
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: data ends inside an object")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}       # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        if b in (0xC7, 0xC8, 0xC9):                        # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.read_ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:                              # fixext
            return self.read_ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read_ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if self.ext_hook is None:
            return ExtType(code, payload)
        return self.ext_hook(code, payload)
