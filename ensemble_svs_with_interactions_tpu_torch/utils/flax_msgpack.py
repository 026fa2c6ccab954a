"""The port's own msgpack subset: flax variables as
``flax.serialization.to_bytes`` writes them, read and written without the
``msgpack`` or ``flax`` packages.

The format (flax ``serialization.py``): a msgpack map of maps whose
leaves are msgpack ext type 1, an ndarray packed as the msgpack array
``(shape, dtype name, C-order bytes)``, or ext type 3, a numpy scalar
packed the same way.  An array larger than ``MAX_CHUNK_SIZE`` bytes is
written as the map ``{"__msgpack_chunked_array__": True, "shape": {"0":
d0, ...}, "chunks": {"0": flat part, ...}}``.  Maps, arrays, str, bin,
int, float, bool and nil are read and written (a list or tuple is written
as flax writes it, a map keyed "0", "1", ...); any other ext type raises.

Arrays are read with ``np.frombuffer`` on a ``memoryview`` of the input,
so they share its memory (and are read-only), and written from a
``memoryview`` of each array, so no leaf is copied on the way.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax's limit for one array leaf before it is chunked
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Input outside the subset, or malformed."""


# ----------------------------------------------------------------- decoder
_FIXED = {  # type byte -> (struct format, size) of a fixed-width number
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Decoder:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.i = 0

    def take(self, n: int) -> memoryview:
        j = self.i + n
        if j > len(self.buf):
            raise MsgpackError("truncated input")
        out = self.buf[self.i:j]
        self.i = j
        return out

    def length(self, nbytes: int) -> int:
        return struct.unpack(_LEN[nbytes], self.take(nbytes))[0]

    def value(self) -> Any:
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
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.length(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 << (b - 0xDE)))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(1 << (b - 0xC7)))
        raise MsgpackError(f"type byte 0x{b:02x} at offset {self.i - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"map key of type {type(key).__name__}")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"msgpack ext type {code} is not supported")
        arr = _ndarray(payload)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(payload: memoryview) -> np.ndarray:
    """(shape, dtype name, bytes) -> an array over the payload's memory."""
    inner = _Decoder(payload)
    head = inner.take(1)[0]
    if head != 0x93:
        raise MsgpackError("an ndarray payload is a 3-element array")
    shape = inner.value()
    name = inner.value()
    b = inner.take(1)[0]
    if b not in (0xC4, 0xC5, 0xC6):
        raise MsgpackError("an ndarray's data is msgpack bin")
    data = inner.take(inner.length(1 << (b - 0xC4)))
    if inner.i != len(payload):
        raise MsgpackError("trailing bytes in an ndarray payload")
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        raise MsgpackError("bfloat16 arrays are not supported")
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    """Chunked-array maps -> arrays, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(k)] for k in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(k)] for k in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def from_bytes(data) -> Any:
    """Decode ``flax.serialization.to_bytes`` output (bytes, bytearray or
    memoryview) to nested dicts of numpy arrays."""
    buf = memoryview(data).cast("B")
    dec = _Decoder(buf)
    out = dec.value()
    if dec.i != len(buf):
        raise MsgpackError(f"{len(buf) - dec.i} trailing bytes")
    return _unchunk(out)


# ----------------------------------------------------------------- encoder
def _uint_header(n: int, fix_max: int, fix_base: int, codes) -> bytes:
    """A length header: the fix form when n fits, else the 8/16/32-bit
    form (``codes`` per width, None where the type has no such form)."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} is too long for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                return bytes([code]) + struct.pack(fmt, v)
    raise MsgpackError(f"integer {v} does not fit 64 bits")


def _str(v: str) -> bytes:
    raw = v.encode("utf-8")
    return _uint_header(len(raw), 31, 0xA0, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _uint_header(n, -1, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(n: int, code: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fix[n]]) if n in fix
            else _uint_header(n, -1, 0, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code)


def _array_pieces(arr: np.ndarray, code: int, out: List):
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError(f"dtype {arr.dtype} cannot be written")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    data = memoryview(arr.reshape(-1)).cast("B")
    head = [b"\x93", _uint_header(arr.ndim, 15, 0x90, (None, 0xDC, 0xDD))]
    head += [_int(int(d)) for d in arr.shape]
    head += [_str(arr.dtype.name), _bin_header(data.nbytes)]
    head = b"".join(head)
    out += [_ext_header(len(head) + data.nbytes, code), head, data]


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(k): d for k, d in enumerate(arr.shape)},
            "chunks": {str(k): flat[j: j + size] for k, j in
                       enumerate(range(0, flat.size, size))}}


def _pieces(v: Any, out: List):
    if isinstance(v, dict):
        out.append(_uint_header(len(v), 15, 0x80, (None, 0xDE, 0xDF)))
        for k, x in v.items():
            if not isinstance(k, str):
                raise MsgpackError(f"map key of type {type(k).__name__}")
            out.append(_str(k))
            _pieces(x, out)
    elif isinstance(v, np.ndarray):
        if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _pieces(_chunk(v), out)
        else:
            _array_pieces(v, EXT_NDARRAY, out)
    elif isinstance(v, np.generic):
        _array_pieces(np.asarray(v), EXT_NPSCALAR, out)
    elif v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif type(v) is int:
        out.append(_int(v))
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        out.append(_str(v))
    elif type(v) is bytes:
        out += [_bin_header(len(v)), v]
    elif isinstance(v, (list, tuple)):  # flax's state dict of a list
        _pieces({str(k): x for k, x in enumerate(v)}, out)
    else:
        raise MsgpackError(f"cannot write {type(v).__name__}")


def to_bytes(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as ``flax.serialization.
    to_bytes`` does, so that flax's ``from_bytes`` restores them."""
    out: List = []
    _pieces(tree, out)
    return b"".join(out)


def dump(tree: Any, f: BinaryIO) -> None:
    """``to_bytes(tree)`` written to the binary file ``f`` piece by piece:
    each array goes out from its own memory."""
    out: List = []
    _pieces(tree, out)
    for piece in out:
        f.write(piece)
