"""A reader of its own for the JAX package's Orbax checkpoints, so the port
restores them without ``orbax``, ``tensorstore`` or ``zstandard`` (the card's
machine has none of them). It imports numpy and the standard library only;
zstd is ``libzstd.so.1`` through ``ctypes``.

What it reads is a step directory that the JAX ``CheckpointManager`` writes
through Orbax's ``StandardSave``::

    <step>/_CHECKPOINT_METADATA
    <step>/default/_METADATA             tree_metadata: the pytree's key paths
    <step>/default/manifest.ocdbt        the OCDBT database's root manifest
    <step>/default/d/<file>              B-tree nodes (and values)
    <step>/default/ocdbt.process_<n>/    each process's database, whose data
                                         files the root's nodes may name

The database is tensorstore's OCDBT format: a manifest (its configuration,
the table of data files, and the latest versions inline, each a reference to
a B-tree root), B-tree nodes (interior: child references with the keys'
common prefix of each subtree; leaves: values inline or indirect references
(data file, offset, length) into the data files), every manifest and node
framed by a header (magic, length, version, compression) and a CRC-32C
footer. Numbers are LEB128 varints, keys prefix-compressed against the
previous key, and a node's keys relative to the common prefix its parent
records. Each array is a zarr v2 array inside it: ``<name>/.zarray`` (JSON:
shape, chunks, dtype, compressor, fill value, order) and one value a chunk,
``<name>/<i>.<j>`` (``0`` for a 0-d array), zstd-compressed; a chunk never
stored reads as the fill value (zero where it is null). ``bfloat16`` arrays
come back as their 16-bit patterns in a ``BFloat16Bits`` array, which the
caller turns into its own bfloat16 type.

Only the latest version of the root manifest is read: the version tree of
older generations that follows it is not. Anything else this reader does not
know raises ``OrbaxFormatError`` (a ``ValueError``) naming what it met: a
numbered manifest, another compression, an unknown value kind, zarr3, a
filter, a dtype; a checksum or a length that does not hold raises too. A
missing ``libzstd`` raises ``OSError`` naming it. Nothing returns zeros in
place of data it could not read.

    tree = read_step("ckpt/3")     # nested dicts of numpy arrays
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import struct

import numpy as np

__all__ = ["OrbaxFormatError", "BFloat16Bits", "is_orbax_step", "read_step", "read_array",
           "Database", "zstd_decompress"]

_MANIFEST_MAGIC, _NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_ZSTD_LIBS = ("libzstd.so.1", "libzstd.so")
# value types whose leaves are zarr arrays; "None" leaves (an empty optimizer
# state) hold nothing
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")


class OrbaxFormatError(ValueError):
    """An Orbax/OCDBT/zarr encoding this reader does not cover, or data that
    fails its own checks."""


class BFloat16Bits(np.ndarray):
    """A ``bfloat16`` array as its 16-bit patterns (``uint16``): numpy has no
    bfloat16 type."""


def is_orbax_step(path) -> bool:
    """Whether ``path`` is a step directory an Orbax manager wrote."""
    return os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA")) or \
        os.path.isfile(os.path.join(path, "default", "_METADATA"))


# ---------------------------------------------------------------------------
# zstd through ctypes
# ---------------------------------------------------------------------------
_ZSTD = None
_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR = (1 << 64) - 1, (1 << 64) - 2


def _libzstd():
    global _ZSTD
    if _ZSTD is None:
        names = list(_ZSTD_LIBS)
        found = ctypes.util.find_library("zstd")
        if found:
            names.append(found)
        for name in names:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = (ctypes.c_char_p, ctypes.c_size_t)
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                            ctypes.c_size_t)
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = (ctypes.c_size_t,)
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = (ctypes.c_size_t,)
            _ZSTD = lib
            break
        else:
            raise OSError(f"libzstd not found (tried {', '.join(names)}): reading an Orbax "
                          "checkpoint needs the zstd library")
    return _ZSTD


def zstd_decompress(data: bytes, size: int | None = None, limit: int = 1 << 31) -> bytes:
    """The decompressed bytes of one or more zstd frames. ``size``: the
    expected size where the caller knows it; else the frame's content size,
    or a buffer grown up to ``limit`` where the frame does not record it."""
    lib = _libzstd()
    data = bytes(data)
    if size is None:
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        if size == _CONTENTSIZE_ERROR:
            raise OrbaxFormatError("not a zstd frame")
    grow = size == _CONTENTSIZE_UNKNOWN
    cap = max(1, 4 * len(data)) if grow else size
    while True:
        buf = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(buf, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            if not grow and n != size:
                raise OrbaxFormatError(f"zstd gave {n} bytes where {size} were expected")
            return buf.raw[:n]
        err = lib.ZSTD_getErrorName(n).decode()
        if grow and "too small" in err and cap < limit:
            cap = min(limit, 4 * cap)
            continue
        raise OrbaxFormatError(f"zstd: {err}")


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------
def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Little-endian fields and LEB128 varints over ``data``; ``what`` names
    the structure in errors."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: truncated at byte {self.pos} ({n} wanted, "
                                   f"{len(self.data) - self.pos} left)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint over 64 bits at byte {self.pos}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OrbaxFormatError(f"{self.what}: {len(self.data) - self.pos} bytes left over "
                                   f"after byte {self.pos}")


def _framed(raw: bytes, magic: int, what: str, max_size: int) -> _Cursor:
    """The body of a manifest or a node: header (magic, length, version,
    compression), the body, CRC-32C footer; checked and decompressed."""
    if len(raw) < 16:
        raise OrbaxFormatError(f"{what}: {len(raw)} bytes is too short")
    got = struct.unpack(">I", raw[:4])[0]
    if got != magic:
        raise OrbaxFormatError(f"{what}: magic 0x{got:08x}, expected 0x{magic:08x}")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise OrbaxFormatError(f"{what}: its header gives {length} bytes, it has {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise OrbaxFormatError(f"{what}: CRC-32C checksum does not match")
    head = _Cursor(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version} (only 0 is covered)")
    method = head.varint()
    body = head.data[head.pos:]
    if method == 1:
        body = zstd_decompress(body, limit=max_size)
    elif method != 0:
        raise OrbaxFormatError(f"{what}: compression method {method} (only none and zstd)")
    return _Cursor(body, what)


def _data_file_table(c: _Cursor) -> list[str]:
    """The node's or manifest's data files: paths relative to the database,
    each its base path + relative path, prefix-compressed."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            raise OrbaxFormatError(f"{c.what}: data file {i}'s prefix or base path runs past "
                                   "its path")
        full = prev[:prefix[i]] + c.take(suffix[i])
        paths.append(full.decode())
        prev = full
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    """The ``n`` keys (each its shared prefix with the previous key's length,
    its suffix's length, then the suffixes), and in an interior node the
    subtrees' common-prefix lengths, which sit before the suffixes."""
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxFormatError(f"{c.what}: key {i} shares {prefix[i]} bytes of a "
                                   f"{len(prev)}-byte key")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class Database:
    """An OCDBT database in the directory ``root``: its latest version's
    keys and values (read once, when it opens; values when asked for)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            raw = f.read()
        c = _framed(raw, _MANIFEST_MAGIC, path, 1 << 26)
        c.take(16)   # the database's uuid
        kind = c.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind} (numbered manifests) is not "
                                   "covered, only a single manifest")
        c.varint()   # max_inline_value_bytes
        self.max_node_bytes = c.varint()
        c.byte()     # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.take(4)   # the zstd level, int32
        elif method != 0:
            raise OrbaxFormatError(f"{path}: compression method {method} in the config")
        files = _data_file_table(c)
        n = c.varint()
        if n == 0:
            raise OrbaxFormatError(f"{path}: the manifest holds no version inline")
        generation, height = c.varints(n), [c.byte() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)              # the roots' statistics
        c.take(8 * n)                 # commit times
        latest = max(range(n), key=lambda i: generation[i])
        self.generation = generation[latest]
        self.values: dict[bytes, tuple] = {}
        if length[latest]:            # an empty tree has no root
            self._walk(self._file(files, file_id[latest], path), offset[latest],
                       length[latest], height[latest], b"")

    def _file(self, files: list[str], i: int, what: str) -> str:
        if i >= len(files):
            raise OrbaxFormatError(f"{what}: data file {i} of {len(files)}")
        full = os.path.normpath(os.path.join(self.root, files[i]))
        if not full.startswith(self.root + os.sep):
            raise OrbaxFormatError(f"{what}: data file {files[i]!r} lies outside the database")
        return full

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes wanted at {offset}, "
                                   f"{len(data)} there")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"B-tree node at {path}:{offset}"
        c = _framed(self._read(path, offset, length), _NODE_MAGIC, what, self.max_node_bytes)
        got = c.byte()
        if got != height:
            raise OrbaxFormatError(f"{what}: height {got}, its parent says {height}")
        files = _data_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, interior=height > 0)
        if height == 0:
            lengths = c.varints(n)
            kinds = [c.byte() for _ in range(n)]
            bad = sorted(set(kinds) - {0, 1})
            if bad:
                raise OrbaxFormatError(f"{what}: value kind {bad[0]} (0 inline, 1 indirect)")
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
            for i, fid, off in zip(indirect, ids, offsets):
                self.values[prefix + keys[i]] = (self._file(files, fid, what), off, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    self.values[prefix + keys[i]] = (c.take(lengths[i]),)
            c.end()
            return
        ids, offsets, lens = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)   # the subtrees' statistics
        c.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OrbaxFormatError(f"{what}: subtree prefix of {common[i]} bytes on a "
                                       f"{len(keys[i])}-byte key")
            self._walk(self._file(files, ids[i], what), offsets[i], lens[i], height - 1,
                       prefix + keys[i][:common[i]])

    def get(self, key) -> bytes | None:
        """The value of ``key``, or None where the database has none."""
        ref = self.values.get(key.encode() if isinstance(key, str) else key)
        if ref is None:
            return None
        return ref[0] if len(ref) == 1 else self._read(*ref)


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------
def _zarr_dtype(text: str) -> np.dtype:
    if text == "bfloat16":
        return np.dtype("<u2")
    try:
        dtype = np.dtype(text)
    except TypeError as e:
        raise OrbaxFormatError(f"zarr dtype {text!r} is not covered") from e
    if dtype.kind not in "biuf":
        raise OrbaxFormatError(f"zarr dtype {text!r} is not covered (numbers and bool only)")
    return dtype


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(value)
        if value is None:
            raise OrbaxFormatError(f"zarr fill value {value!r} is not covered")
    if bf16:
        return np.array(value, np.float32).view(np.uint32) >> 16
    return value


def read_array(db: Database, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``db``, whole."""
    raw = db.get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"no zarr array {name!r} in {db.root} (no {name}/.zarray)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')} (only 2)")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']} are not covered")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: zarr compressor {comp.get('id')!r} (only zstd)")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"{name}: zarr order {order!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = db.get(f"{name}/{key}")
        if data is None:
            continue   # never stored: the fill value
        if comp is not None:
            data = zstd_decompress(data, nbytes)
        if len(data) != nbytes:
            raise OrbaxFormatError(f"{name}/{key}: {len(data)} bytes for a chunk of {nbytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out.view(BFloat16Bits) if bf16 else out


# ---------------------------------------------------------------------------
# the checkpoint's tree
# ---------------------------------------------------------------------------
def read_step(step_dir) -> dict:
    """The pytree an Orbax ``StandardSave`` stored in ``step_dir``, as
    nested dicts keyed by the tree's keys (sequence indices as strings),
    leaves numpy arrays (``BFloat16Bits`` for bfloat16), a ``None`` leaf as
    an empty dict (Flax's serialization of an empty optimizer state)."""
    item = os.path.join(step_dir, "default")
    path = os.path.join(item, "_METADATA")
    with open(path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise OrbaxFormatError(f"{path}: use_ocdbt is false (only OCDBT stores are covered)")
    if meta.get("use_zarr3", False):
        raise OrbaxFormatError(f"{path}: use_zarr3 is true (only zarr v2 is covered)")
    db = Database(item)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value.get("value_type")
        if kind == "None" or value.get("skip_deserialize"):
            leaf = {}
        elif kind in _ARRAY_TYPES:
            leaf = read_array(db, ".".join(keys))
        else:
            raise OrbaxFormatError(f"{path}: leaf {'/'.join(keys)!r} of value type {kind!r} "
                                   f"(covered: {', '.join(_ARRAY_TYPES)}, None)")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
