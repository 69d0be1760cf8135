"""A read-only HDF5 reader of its own, so the port needs no ``h5py`` (a
machine with PyTorch and CUDA may well lack it). It reads the subset that
h5py and Keras write by default (``libver="earliest"``), which is what a
Keras ``save_weights`` / ``model.save`` ``.h5`` file holds:

  * superblock version 0 at the start of the file, 8-byte offsets and
    lengths (as h5py writes it);
  * version-1 object headers, with continuation messages;
  * symbol-table groups: version-1 B-tree group nodes (any depth), ``SNOD``
    symbol nodes and the group's local heap, members in name order;
  * dataspaces (scalar or simple, versions 1 and 2); datatypes:
    little-endian IEEE float16/32/64, little-endian integers of 1-8 bytes,
    fixed-length strings (numpy ``S``, as h5py gives them);
  * contiguous and compact data layouts (version 3); an empty dataset, whose
    address is undefined, reads as an empty array;
  * version-1 attributes of those datatypes (a scalar attribute reads as a
    numpy scalar, an array one as an array, as h5py gives them).

Anything else raises ``ValueError`` naming what it found and its byte offset,
never garbage: another superblock version (``libver="latest"`` writes 2 or
3), new-style groups (link messages) or dense attribute storage, a chunked
layout, a filter pipeline (gzip and the rest), variable-length or other
datatypes, a shared (committed) datatype, a soft or external link, a dataset
whose storage was never allocated. Objects are parsed when they are opened,
so an unsupported one raises when it is reached, as reading it with h5py is
where the caller would meet it.

    f = File(path)                        # reads the file's bytes once
    names = f.attrs["layer_names"]        # np.ndarray of bytes
    kernel = np.asarray(f["Conv1"]["Conv1/kernel:0"])
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np

__all__ = ["File", "Group", "Dataset"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
# object header message types
_NIL, _DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x3, 0x4, 0x5
_LAYOUT, _FILTERS, _ATTRIBUTE, _COMMENT = 0x8, 0xB, 0xC, 0xD
_MTIME_OLD, _CONTINUATION, _SYMBOL_TABLE, _MTIME = 0xE, 0x10, 0x11, 0x12
# messages that change nothing a reader returns
_IGNORED = {_NIL, _FILL_OLD, _FILL, _COMMENT, _MTIME_OLD, _MTIME}
_READ = {_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE, _SYMBOL_TABLE}
_NAMES = {0x2: "link info (a new-style group)", 0x6: "link (a new-style group)",
          0xA: "group info (a new-style group)", _FILTERS: "filter pipeline",
          0x15: "attribute info (dense attribute storage)",
          0x16: "object reference count (a version-2 header)"}
# IEEE layouts: size → (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class _Bytes:
    """The file's bytes, read little-endian with bounds checks; addresses
    are relative to ``base`` (the superblock's base address)."""

    offset_size = length_size = 8

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.base = 0

    def take(self, at: int, n: int) -> memoryview:
        if at < 0 or n < 0 or at + n > len(self.data):
            raise ValueError(f"HDF5 data truncated: {n} bytes wanted at byte offset {at}, "
                             f"the file has {len(self.data)}")
        return self.data[at:at + n]

    def uint(self, at: int, n: int) -> int:
        return int.from_bytes(self.take(at, n), "little")

    def offset(self, at: int) -> int:
        return self.uint(at, self.offset_size)

    def length(self, at: int) -> int:
        return self.uint(at, self.length_size)

    def undefined(self, address: int) -> bool:
        return address == (1 << (8 * self.offset_size)) - 1

    def signature(self, at: int, want: bytes, what: str) -> None:
        got = bytes(self.take(at, len(want)))
        if got != want:
            raise ValueError(f"expected the {what} signature {want!r} at byte offset {at}, "
                             f"found {got!r}")


def _datatype(f: _Bytes, at: int) -> np.dtype:
    """A datatype message's numpy dtype."""
    head = f.uint(at, 4)
    cls, version, bits = head & 0xF, (head >> 4) & 0xF, head >> 8
    size = f.uint(at + 4, 4)
    if version != 1:
        raise ValueError(f"datatype version {version} at byte offset {at} is not covered "
                         "(only version 1)")
    if cls in (0, 1) and bits & 0x41:
        raise ValueError(f"big-endian or VAX-order datatype at byte offset {at} is not covered")
    if cls == 0:    # fixed-point
        bit_offset, precision = f.uint(at + 8, 2), f.uint(at + 10, 2)
        if size in (1, 2, 4, 8) and bit_offset == 0 and precision == 8 * size:
            return np.dtype(f"<{'i' if bits & 0x8 else 'u'}{size}")
        raise ValueError(f"integer datatype of {size} bytes, offset {bit_offset}, precision "
                         f"{precision} at byte offset {at} is not covered")
    if cls == 1:    # floating point
        props = (f.uint(at + 10, 2), f.uint(at + 12, 1), f.uint(at + 13, 1),
                 f.uint(at + 15, 1), f.uint(at + 16, 4))
        ieee = _IEEE.get(size)
        if ieee is not None and f.uint(at + 8, 2) == 0 and f.uint(at + 14, 1) == 0 \
                and (bits >> 8) & 0xFF == 8 * size - 1 and (bits >> 4) & 0x3 == 2 \
                and props == (8 * size, *ieee):
            return np.dtype(f"<f{size}")
        raise ValueError(f"floating-point datatype of {size} bytes at byte offset {at} is "
                         "not IEEE little-endian")
    if cls == 3:    # fixed-length string
        return np.dtype(f"S{size}")
    kinds = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumeration", 9: "variable-length", 10: "array"}
    raise ValueError(f"{kinds.get(cls, f'class {cls}')} datatype at byte offset {at} is not "
                     "covered")


def _dataspace(f: _Bytes, at: int) -> tuple[int, ...]:
    """A dataspace message's shape (``()`` for a scalar)."""
    version, rank, flags = f.uint(at, 1), f.uint(at + 1, 1), f.uint(at + 2, 1)
    if version == 1:
        if flags & 0x2:
            raise ValueError(f"dataspace with a permutation at byte offset {at} is not covered")
        dims_at = at + 8
    elif version == 2:
        kind = f.uint(at + 3, 1)
        if kind == 2:
            raise ValueError(f"null dataspace (an empty attribute) at byte offset {at} is "
                             "not covered")
        dims_at = at + 4
    else:
        raise ValueError(f"dataspace version {version} at byte offset {at} is not covered")
    return tuple(f.length(dims_at + i * f.length_size) for i in range(rank))


def _array(data, dtype: np.dtype, shape: tuple[int, ...]) -> np.ndarray:
    """A writable C-order array of ``shape`` from its raw bytes."""
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class _Object:
    """An object header (version 1): its messages, then the group or dataset
    they describe. ``path`` names the object in errors."""

    def __init__(self, f: _Bytes, address: int, path: str):
        self.f, self.path = f, path
        self.at = at = f.base + address
        version = f.uint(at, 1)
        if version != 1:
            sig = bytes(f.take(at, 4))
            what = "a version-2 object header" if sig == b"OHDR" else f"version {version}"
            raise ValueError(f"object header of {path!r} at byte offset {at} is {what}; only "
                             "version 1 is covered")
        count, seen = f.uint(at + 2, 2), 0
        chunks = [(at + 16, f.uint(at + 8, 4))]
        self.messages: list[tuple[int, int]] = []    # (type, byte offset of the data)
        while chunks and seen < count:
            pos, end = chunks.pop(0)
            end += pos
            while pos + 8 <= end and seen < count:
                mtype, msize, mflags = f.uint(pos, 2), f.uint(pos + 2, 2), f.uint(pos + 4, 1)
                data, seen = pos + 8, seen + 1
                if data + msize > end:
                    raise ValueError(f"object header message at byte offset {pos} runs past "
                                     f"its chunk (ends at {end})")
                if mtype == _CONTINUATION:
                    chunks.append((f.base + f.offset(data), f.length(data + f.offset_size)))
                elif mtype not in _IGNORED:
                    if mtype not in _READ:
                        name = _NAMES.get(mtype, "unknown")
                        raise ValueError(f"object header message 0x{mtype:x} ({name}) at byte "
                                         f"offset {pos} in {path!r} is not covered")
                    if mflags & 0x2:
                        raise ValueError(f"shared message of type 0x{mtype:x} at byte offset "
                                         f"{pos} in {path!r} (a committed datatype) is not "
                                         "covered")
                    self.messages.append((mtype, data))
                pos = data + msize

    def find(self, mtype: int) -> list[int]:
        return [at for t, at in self.messages if t == mtype]

    def attributes(self) -> dict[str, int]:
        """name → byte offset of each attribute message."""
        out = {}
        for at in self.find(_ATTRIBUTE):
            f = self.f
            version = f.uint(at, 1)
            if version != 1:
                raise ValueError(f"attribute message version {version} at byte offset {at} "
                                 f"in {self.path!r} is not covered (only version 1)")
            name_size = f.uint(at + 2, 2)
            name = bytes(f.take(at + 8, name_size)).rstrip(b"\0").decode()
            out[name] = at
        return out


class Attributes(Mapping):
    """An object's attributes by name, each decoded when it is read."""

    def __init__(self, obj: _Object):
        self._obj = obj
        self._at = obj.attributes()

    def __getitem__(self, name: str):
        f, at = self._obj.f, self._at[name]
        name_size, type_size, space_size = (f.uint(at + 2, 2), f.uint(at + 4, 2),
                                            f.uint(at + 6, 2))
        type_at = at + 8 + _pad8(name_size)
        space_at = type_at + _pad8(type_size)
        dtype, shape = _datatype(f, type_at), _dataspace(f, space_at)
        data_at = space_at + _pad8(space_size)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        arr = _array(f.take(data_at, n), dtype, shape)
        return arr[()] if shape == () else arr

    def __iter__(self) -> Iterator[str]:
        return iter(self._at)

    def __len__(self) -> int:
        return len(self._at)


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``read()`` or
    ``np.asarray(ds)`` gives its values as a new array."""

    def __init__(self, obj: _Object):
        f, path = obj.f, obj.path
        self.name, self.attrs = path, Attributes(obj)
        found = [obj.find(t) for t in (_DATASPACE, _DATATYPE, _LAYOUT)]
        if [len(at) for at in found] != [1, 1, 1]:
            raise ValueError(f"object {path!r} at byte offset {obj.at} is neither a group nor a "
                             "dataset (a committed datatype?)")
        (space,), (dtype,), (layout,) = found
        self.shape, self.dtype = _dataspace(f, space), _datatype(f, dtype)
        version, cls = f.uint(layout, 1), f.uint(layout + 1, 1)
        if version != 3:
            raise ValueError(f"data layout version {version} at byte offset {layout} in "
                             f"{path!r} is not covered (only version 3)")
        nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        if cls == 0:     # compact: the data are in the message
            size = f.uint(layout + 2, 2)
            self._at = layout + 4
        elif cls == 1:   # contiguous
            address = f.offset(layout + 2)
            size = f.length(layout + 2 + f.offset_size)
            if f.undefined(address):
                if nbytes:
                    raise ValueError(f"dataset {path!r} (layout at byte offset {layout}) has "
                                     "no storage allocated")
                size = 0
            self._at = None if f.undefined(address) else f.base + address
        else:
            kind = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
            raise ValueError(f"{kind} data layout at byte offset {layout} in {path!r} is not "
                             "covered (only contiguous and compact)")
        if size < nbytes:
            raise ValueError(f"dataset {path!r} holds {size} bytes for {nbytes} "
                             f"(layout at byte offset {layout})")
        self._f, self._nbytes = f, nbytes

    def read(self) -> np.ndarray:
        data = self._f.take(self._at, self._nbytes) if self._nbytes else b""
        return _array(data, self.dtype, self.shape)

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"


class Group(Mapping):
    """A symbol-table group: its members by name (in name order), each opened
    when it is looked up; ``g["a/b"]`` looks up a path below it."""

    def __init__(self, obj: _Object):
        f = self._f = obj.f
        self.name, self.attrs = obj.path, Attributes(obj)
        (table,) = obj.find(_SYMBOL_TABLE)
        btree, heap = f.base + f.offset(table), f.base + f.offset(table + f.offset_size)
        f.signature(heap, b"HEAP", "local heap")
        self._names = bytes(f.take(f.base + f.offset(heap + 8 + 2 * f.length_size),
                                   f.length(heap + 8)))
        self._members: dict[str, tuple[int, int]] = {}   # name → (header address, entry)
        self._walk(btree)

    def _walk(self, at: int) -> None:
        f = self._f
        f.signature(at, b"TREE", "B-tree node")
        node_type, level, used = f.uint(at + 4, 1), f.uint(at + 5, 1), f.uint(at + 6, 2)
        if node_type != 0:
            raise ValueError(f"B-tree node at byte offset {at} is of type {node_type}, not a "
                             "group node")
        keys = at + 8 + 2 * f.offset_size
        step = f.length_size + f.offset_size
        for i in range(used):
            child = f.base + f.offset(keys + i * step + f.length_size)
            if level > 0:
                self._walk(child)
            else:
                self._symbols(child)

    def _symbols(self, at: int) -> None:
        f = self._f
        f.signature(at, b"SNOD", "symbol table node")
        entry = 2 * f.offset_size + 24
        for i in range(f.uint(at + 6, 2)):
            e = at + 8 + i * entry
            start = f.offset(e)
            end = self._names.find(b"\0", start)
            if end < 0:
                raise ValueError(f"link name of the symbol entry at byte offset {e} is not in "
                                 "its group's local heap")
            name = self._names[start:end].decode()
            self._members[name] = (f.offset(e + f.offset_size), e)

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name!r} is a dataset, not a group ({path!r})")
            node = node._open(part)
        return node

    def _open(self, name: str):
        address, entry = self._members[name]
        f = self._f
        if f.uint(entry + 2 * f.offset_size, 4) == 2:
            raise ValueError(f"{name!r} in {self.name!r} (symbol entry at byte offset {entry}) "
                             "is a soft link, which is not covered")
        obj = _Object(f, address, f"{self.name.rstrip('/')}/{name}")
        return Group(obj) if obj.find(_SYMBOL_TABLE) else Dataset(obj)

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._members, key=str.encode))

    def __len__(self) -> int:
        return len(self._members)

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class File(Group):
    """An HDF5 file, read into memory once; the root group. A missing file
    raises ``OSError`` (``FileNotFoundError``), as h5py's does."""

    def __init__(self, path):
        with open(path, "rb") as fh:
            f = _Bytes(fh.read())
        f.signature(0, _SIGNATURE, f"{path}: HDF5 superblock")
        version = f.uint(8, 1)
        if version != 0:
            raise ValueError(f"{path}: superblock version {version} at byte offset 0 is not "
                             "covered (only version 0, h5py's libver='earliest'; 'latest' "
                             "writes 2 or 3)")
        sizes = f.uint(13, 1), f.uint(14, 1)
        if sizes != (8, 8):
            raise ValueError(f"{path}: offsets and lengths of {sizes} bytes (superblock at byte "
                             "offset 0) are not covered, only 8")
        f.base = f.offset(24)
        root = 24 + 4 * f.offset_size    # the root group's symbol table entry
        super().__init__(_Object(f, f.offset(root + f.offset_size), "/"))
