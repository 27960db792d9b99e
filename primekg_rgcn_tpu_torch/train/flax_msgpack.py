"""The JAX package's checkpoint encoding, read and written without flax or
the ``msgpack`` package.

A JAX checkpoint's ``path.msgpack`` is ``flax.serialization.to_bytes`` of a
``TrainState``: msgpack of its state dict (nested dicts with string keys;
tuples and named tuples become dicts keyed by position or field name),
each array leaf an ext object. Ext code 1 is an ndarray, code 3 a numpy
scalar (an ndarray of shape ()), both carrying the msgpack array
``(shape, dtype name, raw C-order bytes)``; code 2 is a complex number,
which no checkpoint holds. A leaf of more than ``MAX_CHUNK_SIZE`` bytes is
written as ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat chunk, ...}}``.

:func:`restore` reads every msgpack type such a file uses and returns
dicts, lists, Python scalars, strings, None, and ``torch.Tensor`` leaves in
their stored dtype (``bfloat16`` included). Each leaf is
``torch.frombuffer`` over its slice of the one buffer: with
``device=None`` it stays a view of it, otherwise it is copied once to its
device (a chunked leaf's chunks straight into one tensor there).
:func:`serialize` and :func:`write` encode a tree with msgpack-python's
smallest encoding of every value (``use_bin_type=True``, and
``strict_types=True`` outside the ext objects), as flax does, so that
their bytes equal flax's for the same tree in the same key order. A
tensor or numpy array leaf is written as code 1 and a numpy scalar as
code 3; a restored leaf is written back as code 1.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, Optional

import numpy as np
import torch

# Leaves above this many bytes are chunked (flax's constant: msgpack's limit
# of 2**31 - 1 bytes per object, with a margin).
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint64", "uint32", "uint16", "uint8", "bool")}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _tensor(raw: memoryview, shape, dtype_name: str, device) -> torch.Tensor:
    try:
        dtype = _DTYPES[dtype_name]
    except KeyError:
        raise ValueError(f"unsupported array dtype {dtype_name!r}") from None
    shape = tuple(int(s) for s in shape)
    if not raw.nbytes:
        return torch.empty(shape, dtype=dtype,
                           device=device if device is not None else "cpu")
    t = torch.frombuffer(raw, dtype=dtype).view(shape)
    return t if device is None else t.to(device, copy=True)


class _Reader:
    """One pass over a msgpack buffer; array payloads are memoryview
    slices of it."""

    def __init__(self, buf: memoryview, device):
        self.buf, self.pos, self.device = buf, 0, device

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.buf.nbytes:
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map_(b & 0x0F)
        if b <= 0x9F:
            return self.array_(b & 0x0F)
        if b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        fixed = _FIXED.get(b)
        if fixed is not None:
            return self.unpack(fixed)
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return self.str_(self.unpack(_STR[b]))
        if b in _ARRAY:
            return self.array_(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map_(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def array_(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if out.get(CHUNKED) is True:
            return self.unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_COMPLEX:
            raise ValueError("complex leaves (msgpack ext 2) are not "
                             "supported")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        inner = _Reader(data, None)
        if inner.unpack(">B") != 0x93:
            raise ValueError("an array ext must hold (shape, dtype, bytes)")
        shape = inner.obj()
        name = inner.obj()
        if isinstance(name, bytes):
            name = name.decode()
        b = inner.unpack(">B")
        if b not in _BIN:
            raise ValueError("an array ext's buffer must be msgpack bin")
        raw = inner.take(inner.unpack(_BIN[b]))
        return _tensor(raw, shape if code == EXT_NDARRAY else (), name,
                       self.device)

    def unchunk(self, d: dict) -> torch.Tensor:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        if self.device is None:
            return torch.cat(chunks).view(shape)
        # Each chunk is already on the device: one tensor there, filled in
        # place, so no second copy of the leaf is ever whole.
        out = torch.empty(sum(c.numel() for c in chunks),
                          dtype=chunks[0].dtype, device=self.device)
        at = 0
        for i, c in enumerate(chunks):
            out[at:at + c.numel()].copy_(c)
            at += c.numel()
            chunks[i] = None
        return out.view(shape)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def restore(buf, *, device=None) -> Any:
    """Decode ``buf`` (the bytes of a ``.msgpack`` checkpoint) as
    ``flax.serialization.msgpack_restore`` does, array leaves as tensors
    (see the module docstring). With ``device=None`` the leaves are views
    of ``buf``; otherwise each is copied to ``device``. A read-only
    ``buf`` (``bytes``) is first copied into a bytearray: pass a bytearray
    to read without that copy."""
    view = memoryview(buf)
    if view.readonly:
        # torch.frombuffer wants memory it may write.
        view = memoryview(bytearray(view))
    reader = _Reader(view.cast("B"), device)
    out = reader.obj()
    if reader.pos != view.nbytes:
        raise ValueError(f"{view.nbytes - reader.pos} trailing bytes after "
                         f"the msgpack object")
    return out


# -- the writer ---------------------------------------------------------------


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -0x20 <= x < 0:
        return struct.pack(">b", x)
    if 0x80 <= x <= 0xFF:
        return b"\xcc" + bytes((x,))
    if -0x80 <= x < 0:
        return struct.pack(">Bb", 0xD0, x)
    if 0xFF < x <= 0xFFFF:
        return struct.pack(">BH", 0xCD, x)
    if -0x8000 <= x < -0x80:
        return struct.pack(">Bh", 0xD1, x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, x)
    if -0x80000000 <= x < -0x8000:
        return struct.pack(">Bi", 0xD2, x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, x)
    if -0x8000000000000000 <= x < -0x80000000:
        return struct.pack(">Bq", 0xD3, x)
    raise OverflowError(f"integer {x} does not fit msgpack")


def _sized(n: int, fix: Optional[int], fix_max: int, heads) -> bytes:
    """The header of a sized msgpack object: its fix form below
    ``fix_max``, else the first of ``heads`` ((type byte, struct format,
    max)) that holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for byte, fmt, most in heads:
        if n <= most:
            return struct.pack(">B" + fmt, byte, n)
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


_STR_HEADS = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN_HEADS = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY_HEADS = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP_HEADS = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xA0, 0x1F, _STR_HEADS) + raw


def _host_bytes(leaf) -> tuple:
    """(shape, dtype name, a bytes-like view of the C-order data) of an
    array leaf, copied to the host where it lies on a device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        try:
            name = _NAMES[t.dtype]
        except KeyError:
            raise ValueError(f"unsupported tensor dtype {t.dtype}") from None
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), name, memoryview(raw)
    a = np.asarray(leaf)    # np.ascontiguousarray would make a 0-d array 1-d
    if a.dtype.hasobject or a.dtype.isalignedstruct or a.dtype.kind == "c":
        raise ValueError(f"unsupported array dtype {a.dtype}")
    flat = np.ascontiguousarray(a).reshape(-1)
    return a.shape, a.dtype.name, memoryview(flat.view(np.uint8))


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _chunked(leaf) -> dict:
    """flax's ``_chunk``: the flat leaf in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    item = leaf.element_size() if isinstance(leaf, torch.Tensor) \
        else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = leaf.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(leaf.shape)},
            "chunks": {str(i): flat[at:at + size] for i, at in
                       enumerate(range(0, flat.shape[0], size))}}


def _maybe_chunk(x):
    return _chunked(x) if _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE else x


def _pack(obj, out: Callable[[Any], Any], chunk: bool = True) -> None:
    """Append the encoding of ``obj`` to ``out``. ``chunk``: split large
    dict values (flax's one pass over the tree, which leaves the chunks
    themselves whole)."""
    if obj is None:
        out(b"\xc0")
    elif obj is True or obj is False:
        out(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out(_int(obj))
    elif type(obj) is float:
        out(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        out(_str(obj))
    elif type(obj) in (bytes, bytearray):
        out(_sized(len(obj), None, 0, _BIN_HEADS))
        out(obj)
    elif type(obj) is dict:
        out(_sized(len(obj), 0x80, 0x0F, _MAP_HEADS))
        chunk = chunk and obj.get(CHUNKED) is not True
        for k, v in obj.items():
            _pack(k, out)
            _pack(_maybe_chunk(v) if chunk else v, out, chunk)
    elif type(obj) in (list, tuple):
        out(_sized(len(obj), 0x90, 0x0F, _ARRAY_HEADS))
        for v in obj:
            _pack(v, out, False)
    elif _is_array(obj) or isinstance(obj, np.generic):
        _pack_array(obj, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_array(obj, out) -> None:
    code = EXT_NPSCALAR if isinstance(obj, np.generic) else EXT_NDARRAY
    shape, name, raw = _host_bytes(obj)
    # The ext payload: msgpack of (shape, name, bytes) with the default
    # packer, which also picks the smallest form of each.
    head = (b"\x93" + _sized(len(shape), 0x90, 0x0F, _ARRAY_HEADS)
            + b"".join(_int(int(s)) for s in shape) + _str(name)
            + _sized(raw.nbytes, None, 0, _BIN_HEADS))
    n = len(head) + raw.nbytes
    if n in (1, 2, 4, 8, 16):
        out(struct.pack(">Bb", {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7,
                                16: 0xD8}[n], code))
    else:
        out(_sized(n, None, 0, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                                (0xC9, "I", 0xFFFFFFFF))))
        out(struct.pack(">b", code))
    out(head)
    out(raw)


def serialize(tree) -> bytes:
    """The msgpack bytes of ``tree`` (see the module docstring): equal to
    ``flax.serialization.msgpack_serialize(tree, in_place=True)`` of the
    same tree with numpy leaves."""
    parts: list = []
    _pack(_maybe_chunk(tree), parts.append)
    return b"".join(parts)


def write(tree, f: BinaryIO) -> None:
    """:func:`serialize` into the open binary file ``f``, a leaf at a time:
    no copy of the whole encoding is made, and each device leaf is on the
    host only while it is written."""
    _pack(_maybe_chunk(tree), f.write)
