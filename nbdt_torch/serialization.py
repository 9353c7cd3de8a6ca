"""Reader for flax's ``.msgpack`` checkpoints, in pure Python.

Counterpart of ``flax.serialization.msgpack_restore``, the call with which the
JAX package reads its own checkpoints (``nbdt_tpu/model.py``,
``hierarchy/generate.py``, ``models/convert.py``). The JAX trainer writes
``{"params": ..., "batch_stats": ...}`` with ``flax.serialization.to_bytes``;
this module decodes those bytes without flax and without the ``msgpack``
package, so that a network trained on a TPU loads into the port on a machine
that has neither.

The wire format is msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md):
maps, arrays, str, bin, ints, floats, nil and bool, plus flax's extension
types: ``1`` an ndarray, itself a msgpack ``(shape, dtype name, C-order
bytes)``; ``2`` a native complex, a packed ``(real, imag)``; ``3`` a numpy
scalar, packed as a 0-d ndarray. Arrays over flax's ``MAX_CHUNK_SIZE`` bytes
arrive as ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{...}}`` dicts and are joined back. numpy has no bfloat16, so a bfloat16 leaf
becomes float32 (its uint16 bits widened by 16, which is exact). There is no
writer: the port trains into ``.pth``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ("msgpack_restore", "read_msgpack")

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    """One pass over a msgpack buffer, from ``pos`` on."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return value

    def decode(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            size = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(size)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack((">B", ">H", ">I", ">Q")[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack((">b", ">h", ">i", ">q")[b - 0xD0])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {self.pos - 1} starts no object")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.decode()
            out[key] = self.decode()
        return out

    def ext(self, size: int):
        code = self.unpack(">b")
        data = self.take(size)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Decoder(data).decode()
            return complex(real, imag)
        raise ValueError(f"msgpack: extension type {code} is not one of flax's (1, 2, 3)")


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's ndarray extension: a packed (shape, dtype name, C-order bytes)."""
    shape, dtype, raw = _Decoder(data).decode()
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree):
    """Join flax's chunked arrays back, wherever a dict holds one (flax
    chunks array leaves of dicts only)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """Decode msgpack bytes written by ``flax.serialization.to_bytes`` (or
    ``msgpack_serialize``) into nested dicts and lists of numpy arrays and
    Python scalars, as ``flax.serialization.msgpack_restore`` does, with
    bfloat16 leaves as float32."""
    decoder = _Decoder(data)
    tree = decoder.decode()
    if decoder.pos != len(decoder.buf):
        raise ValueError(f"msgpack: {len(decoder.buf) - decoder.pos} bytes after the object")
    return _unchunk(tree)


def read_msgpack(path) -> dict:
    """:func:`msgpack_restore` of a file, e.g. the JAX trainer's
    ``ckpt-*.msgpack`` (``{"params", "batch_stats"}``)."""
    return msgpack_restore(Path(path).read_bytes())
