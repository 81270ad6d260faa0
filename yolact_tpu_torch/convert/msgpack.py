"""A reader of the msgpack that ``flax.serialization.msgpack_serialize``
writes, so the port reads the JAX package's ``.ckpt`` files on a machine
with neither flax nor msgpack.

It decodes the subset flax emits for a tree of arrays: maps, arrays
(tuples), str, bin, nil, booleans, integers, floats, and flax's ext types
1 (an ndarray: a packed ``(shape, dtype name, C-order bytes)``) and 3 (a
numpy scalar, the same payload, unpacked to a 0-d value).  Anything else
raises: the other ext types, and flax's chunked giant arrays
(``'__msgpack_chunked_array__'``, arrays over 2**30 bytes, which no YOLACT
tensor reaches).  ``bfloat16`` arrays, which numpy has no dtype for, come
back as torch tensors; everything else as numpy.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = '__msgpack_chunked_array__'

# fixed-width headers: byte -> (struct format, kind)
_FIXED = {
    0xcc: ('>B', 'int'), 0xcd: ('>H', 'int'), 0xce: ('>I', 'int'),
    0xcf: ('>Q', 'int'), 0xd0: ('>b', 'int'), 0xd1: ('>h', 'int'),
    0xd2: ('>i', 'int'), 0xd3: ('>q', 'int'), 0xca: ('>f', 'float'),
    0xcb: ('>d', 'float'),
    0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
    0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
    0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
    0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
    0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext'),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('msgpack: truncated data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _FIXED:
            raise ValueError(f'msgpack: unsupported type byte 0x{b:02x}')
        fmt, kind = _FIXED[b]
        n = self.unpack(fmt)
        if kind in ('int', 'float'):
            return n
        if kind == 'str':
            return str(self.take(n), 'utf-8')
        if kind == 'bin':
            return bytes(self.take(n))
        if kind == 'array':
            return self.array(n)
        if kind == 'map':
            return self.map(n)
        return self.ext(n)

    def array(self, n: int) -> Tuple:
        return tuple(self.value() for _ in range(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError('msgpack: chunked arrays (over 2**30 bytes) '
                             'are not supported')
        return out

    def ext(self, n: int):
        code = self.unpack('>b')
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f'msgpack: unsupported ext type {code}')


def _ndarray(payload: bytes):
    """flax's ndarray payload: a msgpack (shape, dtype name, bytes)."""
    shape, name, buffer = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode()
    if name == 'bfloat16':
        import torch
        bits = np.frombuffer(buffer, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """One msgpack value from `data` (all of it)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError('msgpack: trailing bytes after the value')
    return out


def read(path: str) -> Any:
    """The tree of a flax msgpack file (``msgpack_restore`` of its bytes)."""
    with open(path, 'rb') as f:
        return unpackb(f.read())
