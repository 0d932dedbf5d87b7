"""The msgpack subset that ``flax.serialization`` writes, in pure Python.

A ``.spev`` checkpoint is ``flax.serialization.msgpack_serialize`` of a
tree of dicts, lists and arrays.  The port reads and writes that format
without the ``msgpack`` or ``flax`` packages:

- types: nil, bool, int (every width), float32/64, str, bin, array, map;
- ext 1, an ndarray: its payload is itself msgpack of ``(shape, dtype
  name, C-order bytes)``; ext 3, a numpy scalar (the same payload, read
  back as a 0-d value); ext 2, a complex number ``(real, imag)``;
- the ``{'__msgpack_chunked_array__': True, 'shape': {'0': ..}, 'chunks':
  {'0': ..}}`` form flax writes for a leaf over 2^30 bytes: `restore`
  joins it back into one array (`serialize` never writes it).

`packb` encodes as ``msgpack.packb(x, use_bin_type=True)`` does, byte for
byte: ints in their shortest form (non-negative ones unsigned), Python
floats as float64, tuples as arrays.  Arrays are read with
``np.frombuffer`` over the file's bytes, without a per-element loop.

``bfloat16`` has no numpy dtype: such a leaf is read into a
``torch.bfloat16`` tensor from its raw bytes, and a ``torch.bfloat16``
tensor is written under that dtype name.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not msgpack of the supported subset."""


# -- encoder -------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix: Tuple[int, int], codes: Tuple[int, ...],
              fmts: Tuple[str, ...], limits: Tuple[int, ...]) -> None:
    """A length header: a fix form when ``n < fix[1]`` (fix[0] | n), else
    the first of the sized forms whose limit holds n."""
    if fix[1] and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, limit in zip(codes, fmts, limits):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} is too large for msgpack")


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), out, (0, 0), (0xC4, 0xC5, 0xC6), (">B", ">H", ">I"),
              (0xFF, 0xFFFF, 0xFFFFFFFF))
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, (0, 0), (0xC7, 0xC8, 0xC9), (">B", ">H", ">I"),
                  (0xFF, 0xFFFF, 0xFFFFFFFF))
    out.append(code)
    out += data


def _ndarray_payload(arr) -> bytes:
    """``(shape, dtype name, C-order bytes)`` packed, as flax's
    ``_ndarray_to_bytes``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb((tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise TypeError(f"cannot serialise an array of dtype {arr.dtype}")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(x: Any, out: bytearray) -> None:
    # numpy scalars first: np.float64 is a subclass of float, and flax packs
    # it (strict types) as an ext-3 scalar
    if isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x)), out)
    elif x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), out, (0xA0, 32), (0xD9, 0xDA, 0xDB), (">B", ">H", ">I"),
                  (0xFF, 0xFFFF, 0xFFFFFFFF))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bin(bytes(x), out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), out, (0x90, 16), (0xDC, 0xDD), (">H", ">I"), (0xFFFF, 0xFFFFFFFF))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _pack_len(len(x), out, (0x80, 16), (0xDE, 0xDF), (">H", ">I"), (0xFFFF, 0xFFFFFFFF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(x), out)
    elif isinstance(x, complex):
        _pack_ext(EXT_COMPLEX, packb((x.real, x.imag)), out)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__} to msgpack")


def packb(x: Any) -> bytes:
    """Encode ``x`` as ``msgpack.packb(x, use_bin_type=True)`` would, with
    arrays, numpy scalars and complex numbers as flax's ext types."""
    out = bytearray()
    _pack(x, out)
    return bytes(out)


# -- decoder -------------------------------------------------------------------

_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALAR_FMT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
               0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR, _BIN, _ARRAY, _MAP, _EXT = ((0xD9, 0xDA, 0xDB), (0xC4, 0xC5, 0xC6), (0xDC, 0xDD),
                                  (0xDE, 0xDF), (0xC7, 0xC8, 0xC9))
_LEN_FMT = {**dict(zip(_STR, (">B", ">H", ">I"))), **dict(zip(_BIN, (">B", ">H", ">I"))),
            **dict(zip(_ARRAY, (">H", ">I"))), **dict(zip(_MAP, (">H", ">I"))),
            **dict(zip(_EXT, (">B", ">H", ">I")))}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        view = self.buf[self.pos : self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        start = self.pos
        self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(self.buf, start, n)
        if code == EXT_NPSCALAR:
            arr = _ndarray(self.buf, start, n)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == EXT_COMPLEX:
            re, im = unpackb(bytes(self.buf[start : start + n]))
            return complex(re, im)
        raise MsgpackError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SCALAR_FMT:
            return self.unpack(_SCALAR_FMT[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _LEN_FMT:
            n = self.unpack(_LEN_FMT[b])
            if b in _STR:
                return self.string(n)
            if b in _BIN:
                return bytes(self.take(n))
            if b in _ARRAY:
                return [self.read() for _ in range(n)]
            if b in _MAP:
                return self.map(n)
            return self.ext(n)
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray(buf: memoryview, start: int, n: int):
    """An ext-1 payload at ``buf[start:start + n]``: the array over those
    bytes (no copy; read-only), or a bfloat16 tensor."""
    r = _Reader(buf[: start + n], raw=True)
    r.pos = start
    head = r.take(1)[0]
    if head != 0x93:
        raise MsgpackError("an ndarray payload is not a 3-element array")
    shape = tuple(r.read())
    name = r.read().decode("ascii")
    blob_len = _bin_len(r)
    offset = r.pos
    if name == "bfloat16":
        raw = bytearray(buf[offset : offset + blob_len])
        return torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf[offset : offset + blob_len], dtype=np.dtype(name)).reshape(shape)


def _bin_len(r: _Reader) -> int:
    b = r.take(1)[0]
    if b not in _BIN:
        raise MsgpackError("an ndarray payload's data is not bin")
    return r.unpack(_LEN_FMT[b])


def unpackb(data, raw: bool = False) -> Any:
    """Decode one msgpack object from ``data`` (bytes).  ``raw=True`` gives
    str as bytes, as the nested ndarray payload is read."""
    r = _Reader(data, raw)
    out = r.read()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes of extra data after the object")
    return out


# -- flax trees ----------------------------------------------------------------


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(x):
    if isinstance(x, dict):
        if CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unchunk_tree(v) for v in x]
    return x


def _sorted_tree(x):
    if isinstance(x, dict):
        return {k: _sorted_tree(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return [_sorted_tree(v) for v in x]
    return x


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a state-dict tree (dicts
    with str keys, lists, arrays or tensors, Python scalars), byte for
    byte: flax maps the tree through ``jax.tree_util`` first, which sorts
    every dict's keys."""
    return packb(_sorted_tree(tree))


def restore(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree, with chunked
    arrays joined back."""
    return _unchunk_tree(unpackb(data))
