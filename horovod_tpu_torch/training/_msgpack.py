"""The file format of ``flax.serialization.to_bytes`` and
``msgpack_restore``, written by hand: the port's ``save_model`` files are
the JAX package's byte for byte, so a model saved by either package loads
in the other, and neither ``msgpack`` nor ``flax`` is needed.

What it writes, as ``flax.serialization`` does:

* the tree as a state dict: a mapping (a ``TrainState`` too) becomes a
  map with ``str`` keys in the mapping's own order (not sorted), a list
  or tuple a map ``{"0": ..., "1": ...}``, a named tuple a map of its
  fields;
* ``None``, ``bool``, ``int``, ``float``, ``str`` and ``bytes`` as
  msgpack's own types at their smallest width (``float`` as a double);
* a tensor or numpy array as ext type 1: the msgpack of ``(shape, dtype
  name, C-order bytes)``; a numpy scalar as ext type 3, the same for its
  0-d array; a ``complex`` as ext type 2; bfloat16 as its ``int16``
  view's bytes named ``"bfloat16"`` (the name ``ml_dtypes`` gives it);
* an array above :data:`MAX_CHUNK_SIZE` bytes as ``{"__msgpack_chunked_
  array__": True, "shape": {"0": d0, ...}, "chunks": {"0": flat[0:c],
  ...}}`` with chunks of ``MAX_CHUNK_SIZE // itemsize`` elements.

Reading keeps the file in one buffer: an array's bytes are a
``memoryview`` of it until :func:`restore_into` copies them into a
template's tensors through ``torch.frombuffer``, so a 1.6 GB state is not
copied three times on the host.
"""

from __future__ import annotations

import struct
import warnings
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

#: Arrays above this many bytes are written in chunks
#: (``flax.serialization.MAX_CHUNK_SIZE``).
MAX_CHUNK_SIZE = 2**30

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_dict(tree):
    """``tree`` as ``flax.serialization.to_state_dict`` sees it after the
    JAX package's ``save_model`` made its mappings plain dicts: nested
    dicts with ``str`` keys in the tree's own order, array and scalar
    leaves unchanged."""
    from collections.abc import Mapping

    if isinstance(tree, Mapping):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError("Dict keys do not have a unique string "
                             f"representation: {keys}")
        return {str(k): state_dict(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {f: state_dict(getattr(tree, f)) for f in tree._fields}
    if type(tree) in (list, tuple):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return tree


# ------------------------------------------------------------ writing


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError("Integer value out of range")


def _sized(n: int, small: int, codes: Tuple[int, int, int],
           small_limit: int) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: a fix form
    below ``small_limit`` (``small`` + n), else 8/16/32-bit lengths."""
    if small is not None and n < small_limit:
        return struct.pack("B", small + n)
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        return struct.pack(">BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"an object of {n} items or bytes is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, (0xD9, 0xDA, 0xDB), 32) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6), 0)


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, (None, 0xDC, 0xDD), 16)


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, (None, 0xDE, 0xDF), 16)


def _ext_header(length: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if length in fixed:
        head = struct.pack("B", fixed[length])
    else:
        head = _sized(length, None, (0xC7, 0xC8, 0xC9), 0)
    return head + struct.pack("b", code)


def _host_array(x) -> Tuple[str, List[int], memoryview]:
    """``(dtype name, shape, C-order bytes)`` of a tensor or numpy
    array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().resolve_conj().resolve_neg()
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            arr = t.contiguous().view(torch.int16).cpu().numpy()
            name = _BF16
        else:
            try:
                arr = t.contiguous().cpu().numpy()
            except TypeError as e:
                raise ValueError(f"save_model: a {t.dtype} leaf has no "
                                 f"numpy counterpart to write ({e})") from None
            name = arr.dtype.name
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name = list(arr.shape), arr.dtype.name
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return name, shape, memoryview(flat)


class _Out:
    """Headers gathered in a small buffer, array bytes passed straight
    to ``sink``."""

    def __init__(self, sink: Callable[[Any], Any]):
        self.sink = sink
        self.buf = bytearray()

    def small(self, b) -> None:
        self.buf += b
        if len(self.buf) >= 1 << 20:
            self.flush()

    def big(self, data: memoryview) -> None:
        if len(data) < 1 << 16:
            self.small(data)
            return
        self.flush()
        self.sink(data)

    def flush(self) -> None:
        if self.buf:
            self.sink(bytes(self.buf))
            self.buf.clear()


def _array_ext(out: _Out, name: str, shape, data: memoryview,
               code: int = _NDARRAY) -> None:
    inner = bytearray(b"\x93")
    inner += _array_header(len(shape))
    for d in shape:
        inner += _int(int(d))
    inner += _str(name)
    inner += _bin_header(len(data))
    out.small(_ext_header(len(inner) + len(data), code))
    out.small(inner)
    out.big(data)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _chunked(out: _Out, x) -> None:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    out.small(_map_header(3))
    out.small(_str(_CHUNKED) + b"\xc3")
    out.small(_str("shape") + _map_header(len(x.shape)))
    for i, d in enumerate(x.shape):
        out.small(_str(str(i)) + _int(int(d)))
    starts = range(0, n, size)
    out.small(_str("chunks") + _map_header(len(starts)))
    for i, lo in enumerate(starts):
        out.small(_str(str(i)))
        _array_ext(out, *_host_array(flat[lo:lo + size]))


def _pack(out: _Out, obj) -> None:
    if obj is None:
        out.small(b"\xc0")
    elif type(obj) is bool:
        out.small(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.small(_int(obj))
    elif type(obj) in (bytes, bytearray):
        out.small(_bin_header(len(obj)))
        out.big(memoryview(obj))
    elif type(obj) is str:
        out.small(_str(obj))
    elif type(obj) is float:
        out.small(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is dict:
        out.small(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(out, k)
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                _chunked(out, v)
            else:
                _pack(out, v)
    elif _is_array(obj):
        _array_ext(out, *_host_array(obj))
    elif isinstance(obj, np.generic):
        _array_ext(out, *_host_array(np.asarray(obj)), code=_NPSCALAR)
    elif type(obj) is complex:
        payload = b"\x92" + struct.pack(">Bd", 0xCB, obj.real) + \
            struct.pack(">Bd", 0xCB, obj.imag)
        out.small(_ext_header(len(payload), _COMPLEX) + payload)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def dump(tree, sink: Callable[[Any], Any]) -> None:
    """Write ``tree``'s bytes (those of ``flax.serialization.to_bytes``
    of the tree the JAX package's ``save_model`` would see) through
    ``sink``, a ``write`` method: an array's bytes go to it as they leave
    the card, never joined into one buffer."""
    out = _Out(sink)
    sd = state_dict(tree)
    if _is_array(sd) and _nbytes(sd) > MAX_CHUNK_SIZE:
        _chunked(out, sd)
    else:
        _pack(out, sd)
    out.flush()


# ------------------------------------------------------------ reading


class Array:
    """An array of the file: ``shape``, ``dtype`` name and its bytes,
    ``parts`` (``memoryview`` s of the file's buffer, several for a
    chunked array); ``scalar`` for ext type 3."""

    def __init__(self, shape, dtype: str, parts, scalar: bool = False):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.parts = list(parts)
        self.scalar = scalar

    def torch_dtype(self) -> torch.dtype:
        if self.dtype == _BF16:
            return torch.bfloat16
        try:
            return torch.from_numpy(np.empty(0, np.dtype(self.dtype))).dtype
        except TypeError:
            raise ValueError(f"load_model: dtype {self.dtype!r} has no "
                             "torch counterpart") from None

    def tensor(self) -> torch.Tensor:
        """The values as a CPU tensor over the file's buffer (no copy
        for an array of one part)."""
        dtype = self.torch_dtype()
        with warnings.catch_warnings():
            # A read-only buffer (bytes) is only ever read from here.
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable")
            flats = [torch.frombuffer(p, dtype=dtype) if len(p)
                     else torch.empty(0, dtype=dtype) for p in self.parts]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats)
        return flat.reshape(self.shape)

    def value(self):
        """What ``flax.serialization.msgpack_restore`` gives: a numpy
        array (a numpy scalar for ext type 3); bfloat16, which numpy
        lacks, as a tensor."""
        if self.dtype == _BF16:
            return self.tensor().clone()
        arr = np.frombuffer(b"".join(bytes(p) for p in self.parts),
                            dtype=np.dtype(self.dtype)).reshape(self.shape)
        return arr[()] if self.scalar else arr


def _incomplete():
    return ValueError("Unpack failed: incomplete input")


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise _incomplete()
        mv = self.buf[self.pos:end]
        self.pos = end
        return mv

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                   0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"Unpack failed: byte 0x{b:02x} at offset "
                             f"{self.pos - 1} starts no msgpack object")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            return self._ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        if _CHUNKED in d:
            shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return Array(shape, chunks[0].dtype,
                         [p for c in chunks for p in c.parts])
        return d

    def _ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == _COMPLEX:
            re, im = _Reader(payload).obj()
            return complex(re, im)
        if code not in (_NDARRAY, _NPSCALAR):
            raise ValueError(f"Unpack failed: msgpack ext type {code} is "
                             "none of flax's")
        shape, name, data = _Reader(payload).obj()
        if not isinstance(name, str):
            name = str(name, "ascii")
        return Array(shape, name, [data], scalar=code == _NPSCALAR)


def restore(buf) -> Any:
    """The state dict in ``buf`` (bytes or a buffer of the whole file),
    its arrays :class:`Array` s over the buffer. A truncated buffer, or
    one with bytes past the object, raises ``ValueError``, as msgpack's
    ``unpackb`` does."""
    reader = _Reader(memoryview(buf).cast("B"))
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("unpack(b) received extra data.")
    return tree


def restore_into(template, state, path: str = "", values=None):
    """Walk ``template`` against the state dict ``state`` as
    ``flax.serialization.from_state_dict`` does (a template key, list
    item or field missing from the file raises ``ValueError``; keys only
    the file has are ignored), replacing every leaf that is not a tensor
    by the file's value (dicts and lists in place, tuples rebuilt).

    A rank that read no file passes ``state=None`` and the root's
    ``values``: nothing is checked, and the leaves that are not tensors
    take ``values`` in order. Both walks visit the template's leaves in
    the same order. Returns ``(node, tensors, files, values)``: the
    template, its tensor leaves, the file's tensors still to copy into
    them (none without a file) and the values its other leaves took."""
    from collections.abc import Mapping

    tensors: list = []
    files: list = []
    taken: list = []
    fill = None if values is None else iter(values)

    def walk(node, st, at):
        def child(key):
            return None if fill is not None else st[key]

        if isinstance(node, Mapping):
            if fill is None:
                if not isinstance(st, dict):
                    raise ValueError(
                        f"load_model: the file holds a {type(st).__name__}"
                        f" where the template has a mapping at path "
                        f"{at or '/'}")
                diff = set(map(str, node.keys())).difference(st.keys())
                if diff:
                    raise ValueError(
                        "The target dict keys and state dict keys do not "
                        f"match, target dict contains keys {diff} which "
                        f"are not present in state dict at path "
                        f"{at or '/'}")
            for k in list(node.keys()):
                node[k] = walk(node[k], child(str(k)), f"{at}/{k}")
            return node
        if _is_namedtuple(node) or type(node) in (list, tuple):
            fields = (list(node._fields) if _is_namedtuple(node)
                      else [str(i) for i in range(len(node))])
            if fill is None:
                if not isinstance(st, dict):
                    raise ValueError(
                        f"load_model: the file holds a {type(st).__name__}"
                        f" where the template has a {type(node).__name__}"
                        f" at path {at or '/'}")
                if _is_namedtuple(node) and set(st) != set(fields):
                    raise ValueError(
                        "The field names of the state dict and the named "
                        f"tuple do not match, got {set(st)} and "
                        f"{set(fields)} at path {at or '/'}")
                if not _is_namedtuple(node) and len(st) != len(node):
                    raise ValueError(
                        "The size of the list and the state dict do not "
                        f"match, got {len(node)} and {len(st)} at path "
                        f"{at or '/'}")
            vals = [walk(v, child(f), f"{at}/{f}") for v, f in
                    zip(node, fields)]
            if type(node) is list:
                node[:] = vals
                return node
            return type(node)(*vals) if _is_namedtuple(node) \
                else tuple(vals)
        if isinstance(node, torch.Tensor):
            if fill is None:
                if not isinstance(st, Array):
                    raise ValueError(
                        f"load_model: the file holds a {type(st).__name__}"
                        f" where the template has a tensor at path "
                        f"{at or '/'}")
                if st.shape != tuple(node.shape) or \
                        st.torch_dtype() != node.dtype:
                    raise ValueError(
                        f"load_model: the file's {st.dtype}"
                        f"{list(st.shape)} does not fit the template's "
                        f"tensor {node.dtype}{list(node.shape)} at path "
                        f"{at or '/'}")
                files.append(st.tensor())
            tensors.append(node)
            return node
        got = value(st) if fill is None else next(fill)
        taken.append(got)
        return got

    return walk(template, state, path), tensors, files, taken


def value(tree):
    """A restored state dict as ``flax.serialization.msgpack_restore``
    gives it: :class:`Array` s as numpy values (:meth:`Array.value`),
    ``bin`` as ``bytes``."""
    if isinstance(tree, Array):
        return tree.value()
    if isinstance(tree, memoryview):
        return bytes(tree)
    if isinstance(tree, dict):
        return {k: value(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [value(v) for v in tree]
    return tree
