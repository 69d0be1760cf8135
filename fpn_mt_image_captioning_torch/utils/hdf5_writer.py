"""An HDF5 writer of its own, so the port writes Keras ``.h5`` files without
``h5py``. It writes the subset that ``utils/hdf5.py`` reads and that h5py
writes by default (``libver="earliest"``): superblock version 0 with 8-byte
offsets and lengths, version-1 object headers, symbol-table groups (a
version-1 B-tree of one level over symbol nodes of at most eight entries, and
the group's local heap), contiguous datasets and version-1 attributes, with
little-endian IEEE floats (16, 32, 64 bits), little-endian integers (1-8
bytes) and fixed-length byte strings (numpy ``S``). A 0-d array is a scalar
dataspace; an empty one has no storage (an undefined address), as h5py
writes it. Anything else raises ``ValueError`` naming it (another dtype, a
message over 64 KiB, which h5py would move to dense attribute storage).

    root = Tree()
    root.attrs["layer_names"] = np.array([b"Conv1"])
    g = root.group("Conv1")
    g.dataset("Conv1/kernel:0", kernel)      # creates the group Conv1/Conv1
    g.attrs["weight_names"] = np.array([b"Conv1/kernel:0"])
    write("weights.h5", root)
"""

from __future__ import annotations

import numpy as np

from .hdf5 import _IEEE, _SIGNATURE

__all__ = ["Tree", "write"]

_UNDEFINED = (1 << 64) - 1
_LEAF_K = 4                 # a symbol node holds 2·K entries (h5py's default K)
_SNOD_ENTRIES = 2 * _LEAF_K
_ENTRY = 40                 # a symbol table entry: 8 + 8 + 4 + 4 + 16 bytes
_HEAP_FREE_NULL = 1         # "no free block" in a local heap
# message types
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _ATTRIBUTE, _SYMBOL_TABLE = 0x1, 0x3, 0x5, 0x8, 0xC, 0x11
# the fill value message h5py writes: version 2, late allocation, written if
# set, a default fill value of no bytes
_FILL_MESSAGE = bytes([2, 2, 2, 1, 0, 0, 0, 0])


class Tree:
    """A group to write: ``members`` (name → ``Tree`` or numpy array) and
    ``attrs`` (name → numpy array or scalar)."""

    def __init__(self):
        self.members: dict[str, Tree | np.ndarray] = {}
        self.attrs: dict[str, np.ndarray] = {}

    def group(self, path: str) -> "Tree":
        """The group at ``path`` below this one, created with its parents."""
        node = self
        for part in path.strip("/").split("/"):
            child = node.members.setdefault(part, Tree())
            if not isinstance(child, Tree):
                raise ValueError(f"{part!r} of {path!r} is a dataset, not a group")
            node = child
        return node

    def dataset(self, path: str, data) -> None:
        """A dataset of ``data`` at ``path`` below this group (its parent
        groups created)."""
        parent, _, name = path.strip("/").rpartition("/")
        node = self.group(parent) if parent else self
        if name in node.members:
            raise ValueError(f"{path!r} exists already")
        node.members[name] = np.asarray(data)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _u(n: int, size: int) -> bytes:
    return int(n).to_bytes(size, "little")


def _datatype(dtype: np.dtype) -> bytes:
    """A version-1 datatype message of ``dtype``."""
    size = dtype.itemsize
    if dtype.kind in "iu" and dtype.byteorder in "<=|" and size in (1, 2, 4, 8):
        bits = 0x8 if dtype.kind == "i" else 0
        return bytes([0x10, bits, 0, 0]) + _u(size, 4) + _u(0, 2) + _u(8 * size, 2)
    if dtype.kind == "f" and dtype.byteorder in "<=" and size in _IEEE:
        exp_at, exp_size, mant_size, bias = _IEEE[size]
        # mantissa normalization 2 (msb implied), sign at the top bit
        head = bytes([0x10 | 1, 0x20, 8 * size - 1, 0]) + _u(size, 4)
        return head + _u(0, 2) + _u(8 * size, 2) + bytes([exp_at, exp_size, 0, mant_size]) \
            + _u(bias, 4)
    if dtype.kind == "S":
        return bytes([0x10 | 3, 0x1, 0, 0]) + _u(size, 4)   # null-padded ASCII
    raise ValueError(f"dtype {dtype} is not covered by the HDF5 writer (little-endian "
                     "IEEE floats, little-endian integers, fixed-length bytes)")


def _dataspace(shape: tuple[int, ...]) -> bytes:
    """A version-1 dataspace message (rank 0 is a scalar); the maximum
    dimensions equal the dimensions, as h5py writes them."""
    if not shape:
        return bytes([1, 0, 0, 0]) + bytes(4)
    dims = b"".join(_u(d, 8) for d in shape)
    return bytes([1, len(shape), 1, 0]) + bytes(4) + dims + dims


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    size = _pad8(len(data))
    if size > 0xFFFF:
        raise ValueError(f"an object header message of {size} bytes (type 0x{mtype:x}) "
                         "exceeds the 65535 a version-1 header holds")
    return _u(mtype, 2) + _u(size, 2) + bytes([flags, 0, 0, 0]) + data.ljust(size, b"\0")


def _attribute(name: str, value) -> bytes:
    value = np.asarray(value)
    dtype, space = _datatype(value.dtype), _dataspace(value.shape)
    raw = name.encode() + b"\0"
    data = (bytes([1, 0]) + _u(len(raw), 2) + _u(len(dtype), 2) + _u(len(space), 2)
            + raw.ljust(_pad8(len(raw)), b"\0") + dtype.ljust(_pad8(len(dtype)), b"\0")
            + space.ljust(_pad8(len(space)), b"\0")
            + np.ascontiguousarray(value).tobytes())
    return _message(_ATTRIBUTE, data)


class _Writer:
    def __init__(self, internal_k: int):
        self.out = bytearray(96)        # the superblock, written last
        self.internal_k = internal_k

    def alloc(self, data: bytes) -> int:
        at = len(self.out)
        self.out += data
        self.out += bytes(_pad8(len(self.out)) - len(self.out))
        return at

    def header(self, messages: list[bytes]) -> int:
        chunk = b"".join(messages)
        return self.alloc(bytes([1, 0]) + _u(len(messages), 2) + _u(1, 4) + _u(len(chunk), 4)
                          + bytes(4) + chunk)

    def dataset(self, arr: np.ndarray) -> int:
        dtype = _datatype(arr.dtype)
        data = np.ascontiguousarray(arr).tobytes()
        address = self.alloc(data) if data else _UNDEFINED
        layout = bytes([3, 1]) + _u(address, 8) + _u(len(data), 8)
        return self.header([_message(_DATASPACE, _dataspace(arr.shape)),
                            _message(_DATATYPE, dtype, flags=1),
                            _message(_FILL, _FILL_MESSAGE, flags=1),
                            _message(_LAYOUT, layout)])

    def group(self, tree: Tree) -> tuple[int, int, int]:
        """Write ``tree`` and what it holds; returns its header's address and
        its B-tree's and local heap's (a symbol entry caches the latter)."""
        names = sorted(tree.members, key=str.encode)
        entries, heap, offsets = [], bytearray(8), []   # offset 0: the empty name
        for name in names:
            offsets.append(len(heap))
            raw = name.encode() + b"\0"
            heap += raw.ljust(_pad8(len(raw)), b"\0")
        for name in names:
            member = tree.members[name]
            if isinstance(member, Tree):
                at, btree_at, heap_at = self.group(member)
                entries.append((at, 1, _u(btree_at, 8) + _u(heap_at, 8)))
            else:
                entries.append((self.dataset(member), 0, bytes(16)))
        heap_data = self.alloc(bytes(heap))
        heap_at = self.alloc(b"HEAP" + bytes([0, 0, 0, 0]) + _u(len(heap), 8)
                             + _u(_HEAP_FREE_NULL, 8) + _u(heap_data, 8))
        snods, keys = [], [0]
        for first in range(0, max(len(names), 1), _SNOD_ENTRIES):
            part = range(first, min(first + _SNOD_ENTRIES, len(names)))
            body = b"".join(_u(offsets[i], 8) + _u(entries[i][0], 8) + _u(entries[i][1], 4)
                            + bytes(4) + entries[i][2] for i in part)
            snods.append(self.alloc((b"SNOD" + bytes([1, 0]) + _u(len(part), 2) + body)
                                    .ljust(8 + _SNOD_ENTRIES * _ENTRY, b"\0")))
            keys.append(offsets[part[-1]] if len(part) else 0)
        if len(snods) > 2 * self.internal_k:
            raise AssertionError("internal K too small for the symbol nodes")
        node = b"TREE" + bytes([0, 0]) + _u(len(snods), 2) + _u(_UNDEFINED, 8) \
            + _u(_UNDEFINED, 8)
        for child, key in zip(snods, keys):
            node += _u(key, 8) + _u(child, 8)
        node += _u(keys[len(snods)], 8)
        size = 24 + 2 * self.internal_k * 8 + (2 * self.internal_k + 1) * 8
        btree_at = self.alloc(node.ljust(size, b"\0"))
        messages = [_message(_SYMBOL_TABLE, _u(btree_at, 8) + _u(heap_at, 8))]
        messages += [_attribute(k, v) for k, v in tree.attrs.items()]
        return self.header(messages), btree_at, heap_at


def _most_symbol_nodes(tree: Tree) -> int:
    here = max(1, -(-len(tree.members) // _SNOD_ENTRIES))
    return max([here] + [_most_symbol_nodes(m) for m in tree.members.values()
                         if isinstance(m, Tree)])


def write(path, root: Tree) -> None:
    """Write ``root`` and everything below it as an HDF5 file at ``path``."""
    w = _Writer(internal_k=max(16, -(-_most_symbol_nodes(root) // 2)))
    header_at, btree_at, heap_at = w.group(root)
    sb = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + _u(_LEAF_K, 2) + _u(w.internal_k, 2)
          + _u(0, 4) + _u(0, 8) + _u(_UNDEFINED, 8) + _u(len(w.out), 8) + _u(_UNDEFINED, 8)
          + _u(0, 8) + _u(header_at, 8) + _u(1, 4) + bytes(4) + _u(btree_at, 8)
          + _u(heap_at, 8))
    w.out[:len(sb)] = sb
    with open(path, "wb") as f:
        f.write(bytes(w.out))
