"""The msgpack encoding of the JAX package's checkpoints, in pure Python.

The JAX package writes its checkpoints with flax's ``msgpack_serialize``
and reads them with ``msgpack_restore`` (flax ``serialization.py``). This
is the port's own copy of that encoding, for machines that have neither
``msgpack`` nor ``flax``:

* msgpack's types: nil, bool, int (every width), float32/64, str, bin,
  array and map; map keys are str or bytes, as msgpack's strict map keys
  require;
* flax's ext types: 1 an ndarray (the msgpack array ``(shape, dtype name,
  C-order bytes)``), 2 a Python complex (the array ``(real, imag)``), 3 a
  numpy scalar (an ndarray of shape ``()``, read back as a scalar);
* flax's chunked leaves: an array of more than :data:`MAX_CHUNK_SIZE`
  bytes that is a map value (or the whole tree) is written as the map
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': ...}}`` of flat pieces, and joined again on reading.

:func:`packb` writes the bytes flax writes for the same tree: maps in
sorted key order (flax copies the tree with ``jax.tree_util`` first,
which sorts dict keys), integers and lengths in msgpack's smallest form,
Python floats as float64. :func:`unpackb` returns arrays as read-only
numpy views of the input, as flax does; a dtype numpy does not name
(flax's ``bfloat16`` among them) raises. Malformed input raises
:class:`MsgpackError`, a ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30     # flax serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class MsgpackError(ValueError):
    """Bytes that are not the msgpack encoding of a checkpoint tree."""


# ------------------------------------------------------------- encoding

def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes) -> None:
    """A length header: the fix form up to ``fix_max``, then the 8-, 16-
    and 32-bit forms of ``codes`` (``None`` where the type has none)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix + n))
        return
    for code, fmt, top in zip(codes, ("B", "H", "I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _str(out: List[bytes], s: str) -> None:
    raw = s.encode("utf-8")
    _header(out, len(raw), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
    out.append(raw)


def _bin(out: List[bytes], raw) -> None:
    _header(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(raw)


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: ``(shape, dtype name, C bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    out: List[bytes] = []
    _header(out, 3, 0x90, 0x0F, (None, 0xDC, 0xDD))
    _header(out, arr.ndim, 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in arr.shape:
        _int(out, int(d))
    _str(out, arr.dtype.name)
    _bin(out, arr.tobytes("C"))
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax ``_chunk``, its keys in flax's (unsorted) order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _pack(out: List[bytes], obj: Any, chunkable: bool,
          sort: bool = True) -> None:
    # Exact types, as flax's strict_types packing: a numpy float64 is a
    # numpy scalar (ext 3), not a Python float.
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _int(out, obj)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        _str(out, obj)
    elif t in (bytes, bytearray):
        _bin(out, obj)
    elif t is list:
        _header(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v, False)
    elif t is dict:
        _header(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in (sorted(obj.items()) if sort else obj.items()):
            _pack(out, k, False)
            _pack(out, v, True)
    elif isinstance(obj, np.ndarray):
        if chunkable and obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(obj), False, sort=False)
        else:
            _ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif t is complex:
        inner: List[bytes] = [b"\x92"]
        _pack(inner, obj.real, False)
        _pack(inner, obj.imag, False)
        _ext(out, EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def packb(tree: Any) -> bytes:
    """flax ``msgpack_serialize(tree)``: the same bytes."""
    out: List[bytes] = []
    _pack(out, tree, True)
    return b"".join(out)


# ------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.buf)}")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"a str at offset {self.pos - n} is not "
                               f"UTF-8: {e}") from None

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(">" + "BHI"[b - 0xC7]))
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} "
                           "starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            at = self.pos
            k = self.obj()
            if type(k) not in (str, bytes):
                raise MsgpackError(f"a map key at offset {at} is "
                                   f"{type(k).__name__}, not str or bytes")
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            parts = _whole(data)
            if (type(parts) is not list or len(parts) != 2
                    or not all(type(p) in (int, float) for p in parts)):
                raise MsgpackError(f"ext 2 holds {parts!r}, not (real, "
                                   "imag)")
            return complex(parts[0], parts[1])
        raise MsgpackError(f"ext type {code} is not one of flax's "
                           "(1 ndarray, 2 complex, 3 numpy scalar)")


def _whole(data: memoryview) -> Any:
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(data):
        raise MsgpackError(f"{len(data) - r.pos} bytes after the object")
    return obj


def _dtype(name: str) -> np.dtype:
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.name != name or dt.hasobject:
        raise MsgpackError(f"an array's dtype {name!r} has no numpy "
                           "equivalent the port reads")
    return dt


def _ndarray(data: memoryview) -> np.ndarray:
    """flax ``_ndarray_from_bytes``: a read-only view of ``data``."""
    r = _Reader(data)
    if r.unpack("B") != 0x93:
        raise MsgpackError("an ndarray is not (shape, dtype, bytes)")
    shape = r.obj()
    name = r.obj()
    # The data is read in place, not copied out as bin.
    b = r.unpack("B")
    if b not in (0xC4, 0xC5, 0xC6):
        raise MsgpackError("an ndarray's data is not bin")
    raw = r.take(r.unpack(">" + "BHI"[b - 0xC4]))
    if r.pos != len(data):
        raise MsgpackError("bytes after an ndarray's data")
    if (type(shape) is not list or not all(type(d) is int and d >= 0
                                           for d in shape)):
        raise MsgpackError(f"an ndarray's shape is {shape!r}")
    if type(name) is bytes:
        name = name.decode("ascii", "replace")
    dt = _dtype(name)
    if len(raw) != dt.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise MsgpackError(f"an ndarray of {dt} {tuple(shape)} holds "
                           f"{len(raw)} bytes")
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        raise MsgpackError(f"a chunked array is malformed: {e}") from None


def _unchunk_tree(d: Any) -> Any:
    """flax ``_unchunk_array_leaves_in_place``: maps only, not lists."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_tree(v)
    return d


def unpackb(data) -> Any:
    """flax ``msgpack_restore(data)``: the tree, arrays as numpy."""
    return _unchunk_tree(_whole(memoryview(data).cast("B")))
