"""Reader and writer of flax's ``.msgpack`` checkpoints, in pure Python.

Counterpart of ``flax.serialization.msgpack_restore`` and ``to_bytes``, the
calls with which the JAX package reads and writes its own checkpoints
(``nbdt_tpu/model.py``, ``hierarchy/generate.py``, ``models/convert.py``).
The JAX trainer writes ``{"params": ..., "batch_stats": ...}`` with
``flax.serialization.to_bytes``; this module decodes those bytes, and writes
the same bytes from nested dicts of numpy arrays, without flax and without
the ``msgpack`` package, so that a network moves between the port and the
JAX package on a machine that has neither.

The wire format is msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md):
maps, arrays, str, bin, ints, floats, nil and bool, plus flax's extension
types: ``1`` an ndarray, itself a msgpack ``(shape, dtype name, C-order
bytes)``; ``2`` a native complex, a packed ``(real, imag)``; ``3`` a numpy
scalar, packed as a 0-d ndarray. Arrays over flax's ``MAX_CHUNK_SIZE`` bytes
arrive as ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{...}}`` dicts and are joined back. numpy has no bfloat16, so a bfloat16 leaf
becomes float32 (its uint16 bits widened by 16, which is exact).

The writer packs as flax does (``msgpack.packb(..., strict_types=True)``):
the smallest encoding of each int, str, bin, array and map, a Python float
as a double, a numpy scalar as extension 3 (a numpy float64 too), and an
array leaf of a dict over ``MAX_CHUNK_SIZE`` bytes chunked. :func:`to_bytes`
keeps each dict's key order and turns lists and tuples into dicts keyed
``"0"``, ``"1"``, ... (flax's state dicts); :func:`msgpack_serialize` sorts
the keys, as flax's copy of the tree through ``jax.tree_util`` does.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ("msgpack_restore", "read_msgpack", "msgpack_serialize", "to_bytes",
           "write_msgpack")

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax's: bytes of one packed array leaf


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


class _Encoder:
    """Appends the msgpack encoding of an object to ``out``."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int, fix_limit: int, codes: tuple) -> None:
        """A size header: ``fix | n`` below ``fix_limit`` (no fix form when
        ``fix`` is None), else the first of ``codes`` (8, 16, 32 bit) that
        holds ``n``."""
        if fix is not None and n < fix_limit:
            self.out.append(fix | n)
            return
        for code, fmt in zip(codes, (">B", ">H", ">I")):
            if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
                self.out.append(code)
                self.out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: size {n} is over 2**32 - 1")

    def int(self, v: int) -> None:
        if 0 <= v < 0x80 or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        fmts = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else \
            ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for code, fmt in fmts:
            bits = 8 * struct.calcsize(fmt)
            if (v < 1 << bits) if v >= 0 else (v >= -(1 << (bits - 1))):
                self.out.append(code)
                self.out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} does not fit 64 bits")

    def ext(self, code: int, data: bytes) -> None:
        n = len(data)
        if n in (1, 2, 4, 8, 16):
            self.out.append(0xD4 + n.bit_length() - 1)
        else:
            self.head(n, None, 0, (0xC7, 0xC8, 0xC9))
        self.out += struct.pack(">b", code)
        self.out += data

    def pack(self, o) -> None:
        t = type(o)
        if o is None:
            self.out.append(0xC0)
        elif t is bool:
            self.out.append(0xC3 if o else 0xC2)
        elif t is int:
            self.int(o)
        elif t is float:
            self.out.append(0xCB)
            self.out += struct.pack(">d", o)
        elif t is str:
            raw = o.encode("utf-8")
            self.head(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            self.out += raw
        elif t in (bytes, bytearray):
            self.head(len(o), None, 0, (0xC4, 0xC5, 0xC6))
            self.out += o
        elif t in (list, tuple):
            self.head(len(o), 0x90, 16, (None, 0xDC, 0xDD))
            for v in o:
                self.pack(v)
        elif t is dict:
            self.head(len(o), 0x80, 16, (None, 0xDE, 0xDF))
            for k, v in o.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(o, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(o))
        elif isinstance(o, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(o)))
        elif t is complex:
            self.ext(_EXT_COMPLEX, _packb((o.real, o.imag)))
        else:
            raise TypeError(f"msgpack: cannot serialize {t.__name__}")


def _packb(o) -> bytes:
    enc = _Encoder()
    enc.pack(o)
    return bytes(enc.out)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray extension payload: a packed (shape, dtype name,
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return _packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size]
                       for i, s in enumerate(range(0, flat.size, size))}}


def _prepare(tree, state_dict: bool, sort: bool):
    """The tree as flax packs it: lists and tuples as index-keyed dicts
    (``state_dict``), keys sorted (``sort``), array leaves of dicts over
    ``MAX_CHUNK_SIZE`` bytes chunked."""
    if isinstance(tree, (list, tuple)) and state_dict:
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        items = [(str(k) if state_dict else k, v) for k, v in tree.items()]
        if state_dict and len({k for k, _ in items}) != len(items):
            raise ValueError(f"Dict keys do not have a unique string representation: {tree}")
        if sort:
            items.sort(key=lambda kv: kv[0])
        return {k: (_chunk(v) if isinstance(v, np.ndarray)
                    and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE
                    else _prepare(v, state_dict, sort)) for k, v in items}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v, state_dict, sort) for v in tree)
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(pytree) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(pytree)`` for a
    tree of dicts, lists, Python scalars and numpy arrays: dict keys
    sorted, as flax's copy of the tree sorts them."""
    return _packb(_prepare(pytree, state_dict=False, sort=True))


def to_bytes(target) -> bytes:
    """The bytes of ``flax.serialization.to_bytes(target)`` for nested dicts
    (lists, tuples) of numpy arrays and scalars, e.g. ``{"params": ...,
    "batch_stats": ...}``: each dict in its own key order."""
    return _packb(_prepare(target, state_dict=True, sort=False))


def write_msgpack(path, target) -> None:
    """Writes :func:`to_bytes` of ``target`` to ``path``, a file that
    ``flax.serialization.msgpack_restore`` (and :func:`read_msgpack`)
    reads back."""
    Path(path).write_bytes(to_bytes(target))
