"""The (data, model) mesh of ranks and the placement of each parameter (port
of ``fpn_mt_image_captioning_tpu/parallel/mesh.py``).

``make_mesh`` builds one ``torch.distributed.device_mesh.DeviceMesh`` over
the world, shaped (data, model) with ``MeshConfig``'s axis names: rank ``r``
sits at data index ``r // model`` and model index ``r % model``. Ranks of one
data index form a model group (tensor parallelism: they hold the same rows
and a shard each of the sharded weights); ranks of one model index form a
data group (data parallelism: they hold other rows and sum their
gradients).

``param_spec`` applies the JAX package's Megatron rules over the Flax path of
a parameter (``weights.py`` names each port parameter by it): q/k/v, ``ffn1``
and ``final_layer`` column-parallel, ``out`` and ``ffn2`` row-parallel, the
stacked multi-view weights ``mva/wq``, ``wo``, ``kv_proj`` and ``kv_bias``;
everything else, the CNN trunk included, is replicated. A spec is a tuple
of axis names (None: not sharded), as a ``PartitionSpec`` reads.
``param_placements`` turns the specs into the one dimension of each port
parameter that is split over the model axis (None: whole), with the JAX
package's fallback to a whole parameter where the dimension does not divide
— and, since the port computes attention head by head on each rank, where a
shard would split a head.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch
from torch import nn

from ..config import MeshConfig

__all__ = ["make_mesh", "mesh_shape", "MeshShape", "param_spec", "param_placements",
           "flax_path", "data_rows", "data_group", "model_group", "axis_size", "axis_index"]

# (regex over the '/'-joined Flax path, spec) — the first match wins
_TP_RULES: list[tuple[str, tuple]] = [
    # batched multi-view attention (stacked per-view weights)
    (r".*/mva/wq$", (None, None, "model")),
    (r".*/mva/bq$", (None, "model")),
    (r".*/mva/wo$", (None, "model", None)),
    (r".*/mva/bo$", ()),
    (r".*/kv_proj$", (None, None, None, "model")),
    (r".*/kv_bias$", (None, None, "model")),
    # standard attention
    (r".*/(wq|wk|wv)/kernel$", (None, "model")),
    (r".*/(wq|wk|wv)/bias$", ("model",)),
    (r".*/out/kernel$", ("model", None)),
    (r".*/out/bias$", ()),
    (r".*/ffn1/kernel$", (None, "model")),
    (r".*/ffn1/bias$", ("model",)),
    (r".*/ffn2/kernel$", ("model", None)),
    (r".*/ffn2/bias$", ()),
    (r"(.*/)?final_layer/kernel$", (None, "model")),
    (r"(.*/)?final_layer/bias$", ("model",)),
]


class MeshShape(NamedTuple):
    """A mesh described by its axes alone (``param_spec`` needs no ranks)."""
    axis_names: tuple
    shape: tuple


def mesh_shape(cfg: MeshConfig | None = None, world: int = 1) -> tuple[int, int]:
    """(data, model) of ``cfg`` over ``world`` ranks; raises where they do
    not fill the world, as the JAX ``make_mesh`` asserts."""
    cfg = cfg or MeshConfig()
    model = max(cfg.model_axis_size, 1)
    data = cfg.data_axis_size if cfg.data_axis_size > 0 else world // model
    if data * model != world or data < 1:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return data, model


def make_mesh(cfg: MeshConfig | None = None, device_type: str = "cuda"):
    """The (data, model) ``DeviceMesh`` over every rank of the default
    process group (which must be up: ``multihost.maybe_initialize``)."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = cfg or MeshConfig()
    data, model = mesh_shape(cfg, torch.distributed.get_world_size())
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def _axes(mesh) -> tuple[tuple, tuple]:
    if isinstance(mesh, MeshShape):
        return tuple(mesh.axis_names), tuple(mesh.shape)
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def axis_size(mesh, axis: int) -> int:
    """The size of the mesh's axis ``axis`` (0 data, 1 model); 1 without a
    mesh or such an axis."""
    if mesh is None:
        return 1
    _, shape = _axes(mesh)
    return shape[axis] if axis < len(shape) else 1


def axis_index(mesh, axis: int) -> int:
    """This rank's index along the mesh's axis ``axis``."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(_axes(mesh)[0][axis])


def _group(mesh, axis: int):
    """The process group of this rank along ``axis``; None where the axis
    has one rank (its collectives are the identity)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(_axes(mesh)[0][axis])


def data_group(mesh):
    return _group(mesh, 0)


def model_group(mesh):
    return _group(mesh, 1)


def data_rows(mesh, n_global: int) -> slice:
    """The rows of a global batch of ``n_global`` rows that this rank's data
    share holds (the stand-in for the JAX ``data_sharding``: the batch axis
    split over the data axis)."""
    d = axis_size(mesh, 0)
    if n_global % d:
        raise ValueError(f"a global batch of {n_global} rows does not divide over {d} "
                         "data shares")
    n = n_global // d
    i = axis_index(mesh, 0)
    return slice(i * n, (i + 1) * n)


def param_spec(path: str, leaf=None, tp: bool = True, mesh=None) -> tuple:
    """The spec of the parameter at the '/'-joined Flax ``path``. With
    ``leaf`` (anything with a ``shape``) and ``mesh`` given, a rule whose
    sharded dimension does not divide by its axis falls back to replication
    (``()``); a mesh with one axis replicates every parameter; renamed axes
    are renamed positionally (the mesh is always (data, model))."""
    if not tp:
        return ()
    for pattern, spec in _TP_RULES:
        if re.match(pattern, path):
            if mesh is not None:
                names, shape = _axes(mesh)
                if "model" not in names:
                    if len(names) < 2:
                        return ()
                    spec = tuple(names[1] if a == "model" else a for a in spec)
                if leaf is not None:
                    sizes = dict(zip(names, shape))
                    dims = tuple(getattr(leaf, "shape", ()))
                    for dim, axis in enumerate(spec):
                        if axis is not None and dims[dim] % sizes[axis] != 0:
                            return ()
            return spec
    return ()


def flax_path(model: nn.Module, name: str) -> tuple[str, bool]:
    """The Flax path of port parameter ``name`` (``weights.from_flax``'s
    names) and whether its tensor is the Flax leaf transposed (a dense
    kernel, ``(out, in)`` here and ``(in, out)`` there)."""
    mod, _, leaf = name.rpartition(".")
    m = model.get_submodule(mod) if mod else model
    transposed = False
    if leaf == "weight":
        if isinstance(m, nn.Linear):
            leaf, transposed = "kernel", True
        elif isinstance(m, nn.Conv2d):
            leaf = "kernel"
        elif isinstance(m, nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "scale"
    return "/".join([*mod.split("."), leaf] if mod else [leaf]), transposed


def param_placements(mesh, model: nn.Module, tp: bool = True) -> dict[str, Any]:
    """``{parameter name: the dimension split over the model axis, or
    None}`` for every parameter of ``model`` (whole, unsharded weights).
    A rule engages only where its dimension divides (``param_spec``) and,
    for the attention weights, where the heads divide by the model axis."""
    model_axis = axis_size(mesh, 1)
    heads_divide = getattr(model, "num_heads", model_axis) % model_axis == 0
    out = {}
    for name, p in model.named_parameters():
        path, transposed = flax_path(model, name)
        shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
        spec = param_spec(path, _Shape(shape), tp, mesh)
        dims = [i for i, a in enumerate(spec) if a is not None]
        dim = dims[0] if dims else None
        if dim is not None and not heads_divide and re.search(
                r"/(mva|mha\d)/|kv_(proj|bias)$", path):
            dim = None
        if dim is not None and transposed:
            dim = p.ndim - 1 - dim
        out[name] = dim
    return out


class _Shape(NamedTuple):
    shape: tuple
