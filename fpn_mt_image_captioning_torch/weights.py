"""Weights across the two packages, and the port's own seeded init.

``from_flax`` turns the JAX package's ``{"params", "batch_stats"}`` variables —
a nested dict of numpy arrays, so no flax is needed — into a state dict for
``models.transformer.Transformer``, whose module names mirror the Flax tree:

  * Dense kernels ``(in, out)`` → ``nn.Linear.weight`` ``(out, in)``;
  * conv kernels HWIO → OIHW (a depthwise ``(3, 3, 1, C)`` becomes
    ``(C, 1, 3, 3)``, the ``groups=C`` layout);
  * LayerNorm / BatchNorm ``scale`` → ``weight``; BatchNorm statistics
    ``mean``/``var`` → ``running_mean``/``running_var``;
  * ``embedding`` → ``nn.Embedding.weight``;
  * the stacks — the encoder's ``kv_proj``/``kv_bias`` and each layer's
    ``mva`` ``wq/bq/wo/bo`` — keep their names and the JAX layout.

``to_flax`` is its inverse. ``train_state_to_flax`` /
``train_state_from_flax`` carry a whole training state in the JAX
``TrainState`` layout, ``{"params", "batch_stats", "opt_state", "step"}``
with ``opt_state`` as flax writes ``(EmptyState(), KerasAdamState(count, m,
v, vhat))``: ``{"0": {}, "1": {"count", "m", "v", "vhat"}}``, the moments
trees shaped like ``params`` and the counters int32 scalars. The port's
checkpoints (``train/checkpoint.py``) store that tree.

Weight files: ``read_flax_msgpack`` and ``write_flax_msgpack`` read and write
the Flax msgpack files of the JAX package (``Pipeline.save_weights`` /
``load_weights``, ``flax.serialization.to_bytes``) with a decoder of their
own, so the port needs neither ``flax`` nor ``msgpack``. They cover the subset
``to_bytes`` writes: maps, str and bin, ints, floats, bool, nil, arrays; ext
type 1 (an ndarray: shape, dtype name, C-order bytes) and ext type 3 (a numpy
scalar); and the ``__msgpack_chunked_array__`` maps that stand for a leaf
above ``MAX_CHUNK_SIZE`` bytes. A ``bfloat16`` leaf, which numpy cannot name,
comes back as a torch tensor. Anything else raises ``ValueError`` naming the
byte offset.

The JAX package's Orbax checkpoints (zstd-compressed OCDBT stores) are read
by ``train/orbax_store.py`` into the same trees.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm32, glorot_uniform_, he_normal_

__all__ = ["from_flax", "to_flax", "train_state_to_flax", "train_state_from_flax",
           "init_weights", "read_flax_msgpack", "write_flax_msgpack", "MAX_CHUNK_SIZE"]

_RENAME = {"scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping, keep_dtype: bool = False) -> dict[str, torch.Tensor]:
    """JAX package variables (numpy leaves) → a float32 state dict for
    ``Transformer.load_state_dict(..., strict=True)``; with ``keep_dtype``
    each tensor keeps its leaf's dtype (a ``bfloat16`` leaf is a torch
    tensor, as ``read_flax_msgpack`` returns it)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            if isinstance(leaf, torch.Tensor):
                a = leaf.detach().cpu()
            else:
                a = torch.from_numpy(np.array(leaf, None if keep_dtype else np.float32))
            if not keep_dtype:
                a = a.float()
            *mods, name = path
            if name == "kernel":
                name = "weight"
                if a.ndim == 4:
                    a = a.permute(3, 2, 0, 1)       # HWIO → OIHW
                elif a.ndim == 2:
                    a = a.T                         # (in, out) → (out, in)
                else:
                    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: "
                                     f"{tuple(a.shape)}")
            else:
                name = _RENAME.get(name, name)
            state[".".join([*mods, name])] = a.contiguous()
    return state


def to_flax(model: nn.Module, keep_dtype: bool = False) -> dict:
    """The inverse of ``from_flax``: the model's weights as the JAX package's
    ``{"params", "batch_stats"}`` tree of float32 numpy arrays; with
    ``keep_dtype`` each leaf keeps its tensor's dtype (``bfloat16`` leaves
    stay torch tensors, which ``write_flax_msgpack`` writes)."""
    return _flax_tree(model, model.state_dict().items(), keep_dtype)


def _flax_tree(model: nn.Module, items, keep_dtype: bool = False) -> dict:
    """``(state-dict key, tensor)`` pairs of ``model`` as a Flax-layout tree."""
    out: dict = {"params": {}, "batch_stats": {}}
    modules = dict(model.named_modules())
    for key, t in items:
        mod, _, name = key.rpartition(".")
        m = modules[mod]
        a = t.detach().to("cpu", None if keep_dtype else torch.float32)
        collection = "params"
        if name in ("running_mean", "running_var"):
            collection, name = "batch_stats", name[len("running_"):]
        elif name == "weight":
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                name = "kernel"
                a = a.T if a.ndim == 2 else a.permute(2, 3, 1, 0)   # → (in, out), HWIO
            elif isinstance(m, nn.Embedding):
                name = "embedding"
            elif isinstance(m, (nn.LayerNorm, BatchNorm32)):
                name = "scale"
            else:
                raise ValueError(f"no Flax name for {key} ({type(m).__name__})")
        node = out[collection]
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        # a copy, detached from the model
        node[name] = (a.contiguous().clone() if a.dtype == torch.bfloat16
                      else np.array(a.numpy(), order="C"))
    return out


def train_state_to_flax(model: nn.Module, count: int, m, v, vhat, step: int) -> dict:
    """A training state as the JAX ``TrainState`` tree: the model's weights
    and statistics, the Keras-Adam ``count`` and moments ``m``/``v``/``vhat``
    (tensors in the order of ``model.named_parameters()``), and ``step``."""
    names = [name for name, _ in model.named_parameters()]
    tree = to_flax(model)
    moments = {k: _flax_tree(model, zip(names, ts))["params"]
               for k, ts in (("m", m), ("v", v), ("vhat", vhat))}
    tree["opt_state"] = {"0": {}, "1": {"count": np.array(count, np.int32), **moments}}
    tree["step"] = np.array(step, np.int32)
    return tree


def train_state_from_flax(tree: Mapping, names: list[str]):
    """The inverse of ``train_state_to_flax``: ``(state dict, count, m, v,
    vhat, step)``, the moments as float32 tensors in the order of ``names``
    (the model's parameter names). A moment tree that lacks a parameter or
    holds another raises ``ValueError``."""
    adam = tree["opt_state"]["1"]
    moments = []
    for k in ("m", "v", "vhat"):
        flat = from_flax({"params": adam[k]})
        if set(flat) != set(names):
            raise ValueError(f"opt_state {k}: parameters {sorted(set(flat) ^ set(names))[:3]} "
                             "differ from the model's")
        moments.append([flat[n] for n in names])
    return (from_flax(tree), int(adam["count"]), *moments, int(tree["step"]))


# ---------------------------------------------------------------------------
# Flax msgpack files
# ---------------------------------------------------------------------------
MAX_CHUNK_SIZE = 2**30   # flax.serialization's limit on one leaf's bytes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_NUMERIC_KINDS = "biufc"


class _Reader:
    """A cursor over msgpack bytes, ``buf[pos:end]``."""

    def __init__(self, buf: memoryview, pos: int = 0, end: int | None = None):
        self.buf, self.pos = buf, pos
        self.end = len(buf) if end is None else end

    def take(self, n: int) -> memoryview:
        if n > self.end - self.pos:
            raise ValueError(f"msgpack data truncated at byte offset {self.pos}: "
                             f"{n} bytes needed, {self.end - self.pos} left")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# tag byte → (struct format of the length, kind) for the sized types
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader):
    at = r.pos
    tag = r.take(1)[0]
    if tag <= 0x7f:
        return tag
    if tag >= 0xe0:
        return tag - 0x100
    if tag == 0xc0:
        return None
    if tag in (0xc2, 0xc3):
        return tag == 0xc3
    if tag in _NUMBERS:
        return r.unpack(_NUMBERS[tag])
    if 0x80 <= tag <= 0x8f:
        kind, n = "map", tag & 0x0f
    elif 0x90 <= tag <= 0x9f:
        kind, n = "array", tag & 0x0f
    elif 0xa0 <= tag <= 0xbf:
        kind, n = "str", tag & 0x1f
    elif tag in _FIXEXT:
        kind, n = "ext", _FIXEXT[tag]
    elif tag in _SIZED:
        fmt, kind = _SIZED[tag]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{tag:02x} at byte offset {at} is not one "
                         "that Flax weight files use")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        data = r.take(n)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack string at byte offset {at} is not UTF-8") from e
    if kind == "array":
        return [_decode(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            key_at = r.pos
            key = _decode(r)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key at byte offset {key_at} is a "
                                 f"{type(key).__name__}, not a string")
            out[key] = _decode(r)
        return _unchunk(out, at) if _CHUNKED in out else out
    code = struct.unpack(">b", r.take(1))[0]
    start = r.pos
    r.take(n)
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} at byte offset {at} is not an ndarray "
                         "(1) or a numpy scalar (3)")
    arr = _decode_ndarray(_Reader(r.buf, start, start + n), at)
    return arr if code == _EXT_NDARRAY else arr[()]


def _decode_ndarray(r: _Reader, at: int):
    """Ext type 1's payload, itself msgpack: [shape, dtype name, C bytes]."""
    tpl = _decode(r)
    if r.pos != r.end or not (isinstance(tpl, list) and len(tpl) == 3
                              and isinstance(tpl[0], list)
                              and all(isinstance(d, int) and d >= 0 for d in tpl[0])
                              and isinstance(tpl[1], str) and isinstance(tpl[2], bytes)):
        raise ValueError(f"ndarray at byte offset {at} is not [shape, dtype, bytes]")
    shape, name, data = tuple(tpl[0]), tpl[1], tpl[2]
    if name == "bfloat16":
        dtype, itemsize = torch.bfloat16, 2
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"ndarray at byte offset {at}: unknown dtype {name!r}") from e
        if dtype.kind not in _NUMERIC_KINDS:
            raise ValueError(f"ndarray at byte offset {at}: dtype {name!r} is not numeric")
        itemsize = dtype.itemsize
    if len(data) != int(np.prod(shape)) * itemsize:
        raise ValueError(f"ndarray at byte offset {at}: {len(data)} bytes for shape "
                         f"{shape} of {name}")
    if dtype is torch.bfloat16:
        if not data:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _unchunk(d: dict, at: int):
    """A leaf that Flax split into chunks (``flax.serialization._chunk``)."""
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):
            flat = torch.cat([c.reshape(-1) for c in chunks])
        else:
            flat = np.concatenate(chunks)
        return flat.reshape(shape)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"chunked array at byte offset {at} is malformed ({e})") from e


def read_flax_msgpack(path) -> dict:
    """A Flax msgpack weight file → its tree: nested dicts whose leaves are
    numpy arrays (read-only views of the file's bytes), numpy scalars, Python
    values, or torch tensors for ``bfloat16`` leaves."""
    with open(path, "rb") as f:
        return _from_bytes(f.read())


def _from_bytes(buf: bytes):
    r = _Reader(memoryview(buf))
    tree = _decode(r)
    if r.pos != r.end:
        raise ValueError(f"{r.end - r.pos} bytes of extra data at byte offset {r.pos}")
    return tree


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack(">b", n)
    else:
        for lo, hi, tag, fmt in ((0, 0xff, 0xcc, ">B"), (-0x80, -1, 0xd0, ">b"),
                                 (0, 0xffff, 0xcd, ">H"), (-0x8000, -1, 0xd1, ">h"),
                                 (0, 0xffffffff, 0xce, ">I"), (-2**31, -1, 0xd2, ">i"),
                                 (0, 2**64 - 1, 0xcf, ">Q"), (-2**63, -1, 0xd3, ">q")):
            if lo <= n <= hi:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int, tags) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt in tags:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_bytes(b, out: bytearray) -> None:
    _pack_len(len(b), out, None, 0, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
    out += b


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode()
    _pack_len(len(b), out, 0xa0, 0x1f, ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
    out += b


def _ndarray_payload(a) -> bytes:
    """Ext type 1's payload, as ``flax.serialization._ndarray_to_bytes``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, data = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            n = t.numpy()
            name, data = n.dtype.name, n.tobytes("C")
        shape = tuple(t.shape)
    else:
        if a.dtype.kind not in _NUMERIC_KINDS:
            raise TypeError(f"cannot write an array of dtype {a.dtype}")
        name, data, shape = a.dtype.name, a.tobytes("C"), a.shape
    out = bytearray(b"\x93")
    _pack_len(len(shape), out, 0x90, 0x0f, ((0xdc, ">H"), (0xdd, ">I")))
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bytes(data, out)
    return bytes(out)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fix is not None:
        out.append(fix)
    else:
        _pack_len(n, out, None, 0, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
    out += struct.pack(">b", code)
    out += data


def _chunked(a) -> dict:
    """``flax.serialization._chunk``: a leaf above ``MAX_CHUNK_SIZE`` bytes
    as a map of flat chunks."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.shape[0], size))}}


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunked(obj), out)
        else:
            _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):    # before float: np.float64 is a float
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bytes(bytes(obj), out)
    elif isinstance(obj, Mapping):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"map keys {list(obj)} are not all strings")
        _pack_len(len(obj), out, 0x80, 0x0f, ((0xde, ">H"), (0xdf, ">I")))
        for k, v in obj.items():
            _pack_str(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 0x0f, ((0xdc, ">H"), (0xdd, ">I")))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} to a Flax msgpack file")


def _to_bytes(tree) -> bytes:
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def write_flax_msgpack(path, tree) -> None:
    """Write ``tree`` (nested dicts of numpy arrays, numpy scalars, torch
    tensors or Python values) as a Flax msgpack file, the bytes
    ``flax.serialization.to_bytes`` writes for the same tree, so the JAX
    package's ``Pipeline.load_weights`` reads it."""
    data = _to_bytes(tree)
    with open(path, "wb") as f:
        f.write(data)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter and statistic, drawn from
    ``generator`` only, with the JAX package's initializers: lecun_normal
    for the backbone's convs (Flax's default), glorot_uniform for the FPN's
    convs and the vocabulary layer (Keras' default, ``models/fpn.py`` and
    ``models/transformer.py``), normal(0.01) for the head trunks' convs,
    he_normal for every other conv, dense and stacked projection kernel;
    zero biases, U(-0.05, 0.05) embeddings (Keras' default), unit norm
    scales, BatchNorm statistics (0, 1). The draws differ from JAX's, since
    the generators do."""
    from .models.attention import MultiViewAttention
    from .models.transformer import Encoder

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            part = name.split(".")
            if "backbone" in part:
                he_normal_(m.weight, fan_in, generator, scale=1.0)
            elif "fpn" in part:
                rf = m.weight[0, 0].numel()
                glorot_uniform_(m.weight, fan_in, rf * m.out_channels // m.groups, generator)
            elif "regression_trunk" in part or "classification_trunk" in part:
                m.weight.normal_(0.0, 0.01, generator=generator)
            else:
                he_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            if name.split(".")[-1] == "final_layer":
                glorot_uniform_(m.weight, m.in_features, m.out_features, generator)
            else:
                he_normal_(m.weight, m.in_features, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-0.05, 0.05, generator=generator)
        elif isinstance(m, (nn.LayerNorm, BatchNorm32)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm32):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, MultiViewAttention):
            for w in (m.wq, m.wo):
                he_normal_(w, w.shape[-2], generator)
            m.bq.zero_()
            m.bo.zero_()
        elif isinstance(m, Encoder):
            he_normal_(m.kv_proj, m.kv_proj.shape[-2], generator)
            m.kv_bias.zero_()

