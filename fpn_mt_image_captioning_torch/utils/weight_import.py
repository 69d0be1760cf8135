"""Keras ``.h5`` weight import for the pretrained MobileNetV2-RetinaNet (port of
``fpn_mt_image_captioning_tpu/utils/weight_import.py``).

The reference boots its FeatureExtractor from a COCO-pretrained Keras weights
file (``model_weights/mobilenet224_1.0_coco.h5``). ``load_keras_h5`` reads
such a file with the port's own HDF5 reader (``utils/hdf5.py``; the port
needs no ``h5py``), and ``import_retinanet_weights`` maps it onto the JAX
package's ``{"params", "batch_stats"}`` tree of numpy arrays, the layout
``weights.to_flax`` / ``from_flax`` carry to and from the port's model:

  * MobileNetV2 backbone — ``Conv1/bn_Conv1``, ``expanded_conv_*``,
    ``block_<n>_{expand,depthwise,project}[_BN]``, ``Conv_1/Conv_1_bn``
    → ``backbone/{stem,block_<g>_<b>,head}/{conv,bn}`` (the Keras flat block
    index n re-derived into (group, block));
  * FPN lateral/output convs — ``C3_reduced/C4_reduced/C5_reduced/P3/P4/P5``
    plus the unnamed P6/P7 convs, matched by shape and file order;
  * head trunks — ``pyramid_regression_<i>`` / ``pyramid_classification_<i>``
    → ``{regression,classification}_trunk/conv_<i>``.

Conv kernels are HWIO in both layouts; Keras DepthwiseConv2D kernels (H, W,
C, 1) transpose to the grouped (H, W, 1, C); BatchNorm's (γ, β, μ, σ²) go to
params (scale/bias) and batch_stats (mean/var). The import is best-effort:
whatever is unmatched keeps its values and is listed in the report's
``missed``, as in the JAX package. ``retinanet_keras_layers`` is the inverse
mapping (a tree to the Keras-named layers whose import gives it back), and
``write_keras_h5`` writes such layers as a Keras ``.h5`` file with the
port's own HDF5 writer (``utils/hdf5_writer.py``). ``apply_flat_updates``
overwrites parameters by flat ``"a/b/c"`` paths, shape-checked (the JAX
package's TF-parity harness pushes a Keras model's weights in with it).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np

from .hdf5 import File
from .hdf5_writer import Tree
from .hdf5_writer import write as write_hdf5

__all__ = ["load_keras_h5", "write_keras_h5", "import_retinanet_weights",
           "retinanet_keras_layers", "apply_flat_updates", "ImportReport"]

# Keras MobileNetV2 flat block index → (group, block-in-group) of
# models/backbones/mobilenet_v2.py's _BLOCK_CONFIG
_KERAS_BLOCK_TO_GB: dict[int, tuple[int, int]] = {}
_n = 0
for _gi, _reps in enumerate((1, 2, 3, 4, 3, 3, 1)):
    for _bi in range(_reps):
        _KERAS_BLOCK_TO_GB[_n] = (_gi, _bi)
        _n += 1
_FPN_NAMED = ("C3_reduced", "C4_reduced", "C5_reduced", "P3", "P4", "P5")
_P6P7_SHAPE = (3, 3, 256, 256)


class ImportReport:
    def __init__(self):
        self.matched: list[str] = []
        self.missed: list[str] = []

    def __repr__(self):
        return f"ImportReport(matched={len(self.matched)}, missed={len(self.missed)})"


def _text(raw) -> str:
    return raw.decode() if isinstance(raw, bytes) else str(raw)


def load_keras_h5(path) -> dict[str, dict[str, np.ndarray]]:
    """Read a Keras save_weights HDF5 into ``{layer_name: {weight_name: array}}``.

    Weights are keyed by the LAYER path component of their
    ``'<[nested model/]layer>/<weight>:0'`` names, not by the group: a nested
    sub-model lists every inner layer's weights under one top-level group.
    ``layer_names`` is followed into nested groups too."""
    out: dict[str, dict[str, np.ndarray]] = {}
    f = File(path)
    root = f["model_weights"] if "model_weights" in f else f

    def visit(group):
        names = group.attrs.get("layer_names")
        if names is None:
            return
        for raw in names:
            g = group[_text(raw)]
            for wn in g.attrs.get("weight_names", []):
                wn = _text(wn)
                parts = wn.split("/")
                layer = parts[-2] if len(parts) >= 2 else _text(raw)
                out.setdefault(layer, {})[parts[-1]] = np.asarray(g[wn])
            visit(g)

    visit(root)
    return out


def _copy_tree(tree: Mapping) -> dict:
    """New dicts all the way down, the leaves as numpy arrays (not copied)."""
    return {k: _copy_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def _set(tree: dict, path: list[str], value: np.ndarray, report: ImportReport,
         label: str) -> None:
    node = tree
    for k in path[:-1]:
        if k not in node:
            report.missed.append(label)
            return
        node = node[k]
    leaf = path[-1]
    if leaf not in node:
        report.missed.append(label)
        return
    if tuple(node[leaf].shape) != tuple(value.shape):
        report.missed.append(f"{label} (shape {value.shape} vs {node[leaf].shape})")
        return
    node[leaf] = value.astype(np.asarray(node[leaf]).dtype)
    report.matched.append(label)


def _import_convbn(params, stats, layers, keras_conv, keras_bn, our, report):
    """Map a Keras conv(+BN) pair into the ``_ConvBN`` module named ``our``."""
    if keras_conv in layers:
        w = layers[keras_conv]
        kernel = w.get("kernel:0", w.get("depthwise_kernel:0"))
        if kernel is not None:
            if "depthwise_kernel:0" in w:
                kernel = np.transpose(kernel, (0, 1, 3, 2))  # (H,W,C,1)→(H,W,1,C)
            _set(params, our + ["conv", "kernel"], kernel, report, keras_conv)
        else:
            report.missed.append(f"{keras_conv} (group has no kernel:0/depthwise_kernel:0)")
        if "bias:0" in w:
            _set(params, our + ["conv", "bias"], w["bias:0"], report, keras_conv + "/bias")
    else:
        report.missed.append(keras_conv)
    if keras_bn and keras_bn in layers:
        b = layers[keras_bn]
        _set(params, our + ["bn", "scale"], b["gamma:0"], report, keras_bn + "/gamma")
        _set(params, our + ["bn", "bias"], b["beta:0"], report, keras_bn + "/beta")
        _set(stats, our + ["bn", "mean"], b["moving_mean:0"], report, keras_bn + "/mean")
        _set(stats, our + ["bn", "var"], b["moving_variance:0"], report, keras_bn + "/var")
    elif keras_bn:
        report.missed.append(keras_bn)


def _mobilenet_pairs():
    """(Keras conv, Keras BN, our module path) of every MobileNetV2 _ConvBN."""
    yield "Conv1", "bn_Conv1", ["stem"]
    yield "Conv_1", "Conv_1_bn", ["head"]
    for flat, (gi, bi) in _KERAS_BLOCK_TO_GB.items():
        prefix = "expanded_conv" if flat == 0 else f"block_{flat}"
        our = f"block_{gi}_{bi}"
        if flat != 0:
            yield f"{prefix}_expand", f"{prefix}_expand_BN", [our, "expand"]
        yield f"{prefix}_depthwise", f"{prefix}_depthwise_BN", [our, "depthwise"]
        yield f"{prefix}_project", f"{prefix}_project_BN", [our, "project"]


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """``"a/b/c" -> leaf`` in the tree's order; empty subtrees drop out, as
    in ``flax.traverse_util.flatten_dict``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Mapping) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def apply_flat_updates(variables: Mapping,
                       updates: Mapping[str, np.ndarray]) -> tuple[dict, ImportReport]:
    """Overwrite parameters by flat ``"a/b/c" -> array`` paths, relative to
    ``variables["params"]`` (the ``weights.to_flax`` layout). Each value
    takes its leaf's dtype; a shape that differs raises ``ValueError``; a
    path the tree lacks is reported in ``missed``. Returns (new variables,
    report); ``variables`` is left as it was."""
    report = ImportReport()
    flat = _flatten(_copy_tree(variables["params"]))
    for path, value in updates.items():
        if path not in flat:
            report.missed.append(path)
            continue
        if flat[path].shape != np.shape(value):
            raise ValueError(f"shape mismatch at {path}: {flat[path].shape} vs {np.shape(value)}")
        flat[path] = np.asarray(value, dtype=flat[path].dtype)
        report.matched.append(path)
    new_vars = dict(variables)
    new_vars["params"] = _unflatten(flat)
    return new_vars, report


def import_retinanet_weights(variables: Mapping, h5_path: Any,
                             n_conv_submodule: int = 2) -> tuple[dict, ImportReport]:
    """Import backbone/FPN/head-trunk weights into a Transformer's variables.

    ``variables``: the ``{"params", "batch_stats"}`` tree of numpy arrays
    (``weights.to_flax``). ``h5_path``: a Keras h5 weight file's path, or an
    already-loaded ``{layer_name: {weight:0 ...}}`` dict. Returns (new
    variables, report); ``variables`` is left as it was, and whatever is
    unmatched keeps its values."""
    layers = h5_path if isinstance(h5_path, dict) else load_keras_h5(h5_path)
    report = ImportReport()

    params = _copy_tree(variables["params"])
    stats = _copy_tree(variables.get("batch_stats", {}))
    fe_params = params["encoder"]["feature_extractor"]
    fe_stats = stats.get("encoder", {}).get("feature_extractor", {})

    bb_p = fe_params["backbone"]
    bb_s = fe_stats.get("backbone", {})
    for keras_conv, keras_bn, our in _mobilenet_pairs():
        _import_convbn(bb_p, bb_s, layers, keras_conv, keras_bn, our, report)

    fpn = fe_params["fpn"]
    for name in _FPN_NAMED:
        if name in layers and "kernel:0" in layers[name]:
            _set(fpn, [name, "kernel"], layers[name]["kernel:0"], report, name)
            if "bias:0" in layers[name]:
                _set(fpn, [name, "bias"], layers[name]["bias:0"], report, name + "/bias")
        else:
            report.missed.append(name)
    # P6/P7 convs are unnamed in the reference graph (auto conv2d_N): match the
    # remaining 3×3 256→256 conv layers by file order
    unnamed = [(n, w) for n, w in layers.items()
               if n.startswith("conv2d") and "kernel:0" in w
               and w["kernel:0"].shape == _P6P7_SHAPE]
    for idx, target in enumerate(("P6_conv", "P7_conv")):
        if idx >= len(unnamed):
            report.missed.append(f"(no unnamed 3x3 256x256 conv #{idx})->{target}")
            continue
        n, w = unnamed[idx]
        _set(fpn, [target, "kernel"], w["kernel:0"], report, f"{n}->{target}")
        if "bias:0" in w:
            _set(fpn, [target, "bias"], w["bias:0"], report, f"{n}->{target}/bias")

    for i in range(n_conv_submodule):
        for keras_name, our_trunk in ((f"pyramid_regression_{i}", "regression_trunk"),
                                      (f"pyramid_classification_{i}", "classification_trunk")):
            if keras_name in layers:
                w = layers[keras_name]
                _set(fe_params, [our_trunk, f"conv_{i}", "kernel"], w["kernel:0"], report,
                     keras_name)
                if "bias:0" in w:
                    _set(fe_params, [our_trunk, f"conv_{i}", "bias"], w["bias:0"], report,
                         keras_name + "/bias")
            else:
                report.missed.append(keras_name)

    new_vars = dict(variables)
    new_vars["params"] = params
    if stats:
        new_vars["batch_stats"] = stats
    return new_vars, report


def retinanet_keras_layers(variables: Mapping,
                           n_conv_submodule: int = 2) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of ``import_retinanet_weights``: the Keras-named
    ``{layer: {weight:0: array}}`` of a MobileNetV2 model's backbone, FPN and
    head trunks, in a Keras file's order (P6/P7 as ``conv2d_1``/``conv2d_2``),
    whose import gives those leaves back exactly."""
    fe = variables["params"]["encoder"]["feature_extractor"]
    fe_s = variables["batch_stats"]["encoder"]["feature_extractor"]
    out: dict[str, dict[str, np.ndarray]] = {}
    for keras_conv, keras_bn, our in _mobilenet_pairs():
        p, s = fe["backbone"], fe_s["backbone"]
        for k in our:
            p, s = p[k], s[k]
        kernel = np.asarray(p["conv"]["kernel"])
        if keras_conv.endswith("_depthwise"):
            out[keras_conv] = {"depthwise_kernel:0": kernel.transpose(0, 1, 3, 2)}
        else:
            out[keras_conv] = {"kernel:0": kernel}
        out[keras_bn] = {"gamma:0": np.asarray(p["bn"]["scale"]),
                         "beta:0": np.asarray(p["bn"]["bias"]),
                         "moving_mean:0": np.asarray(s["bn"]["mean"]),
                         "moving_variance:0": np.asarray(s["bn"]["var"])}
    fpn = fe["fpn"]
    for name in _FPN_NAMED:
        out[name] = {"kernel:0": np.asarray(fpn[name]["kernel"]),
                     "bias:0": np.asarray(fpn[name]["bias"])}
    for i, ours in enumerate(("P6_conv", "P7_conv"), 1):
        out[f"conv2d_{i}"] = {"kernel:0": np.asarray(fpn[ours]["kernel"]),
                              "bias:0": np.asarray(fpn[ours]["bias"])}
    for i in range(n_conv_submodule):
        for keras_name, trunk in ((f"pyramid_regression_{i}", "regression_trunk"),
                                  (f"pyramid_classification_{i}", "classification_trunk")):
            conv = fe[trunk][f"conv_{i}"]
            out[keras_name] = {"kernel:0": np.asarray(conv["kernel"]),
                               "bias:0": np.asarray(conv["bias"])}
    return out


def write_keras_h5(path, layers: Mapping[str, Mapping[str, np.ndarray]]) -> None:
    """Write ``{layer_name: {weight_name: array}}`` in the Keras
    ``save_weights`` HDF5 layout that ``load_keras_h5`` reads, through the
    port's own writer (``utils/hdf5_writer.py``), as the JAX package's
    ``write_keras_h5`` writes it through h5py: the root attribute
    ``layer_names`` (fixed-length byte strings), a group a layer holding its
    datasets at ``<layer>/<layer>/<weight>`` (the full name inside the layer's
    group nests a second group) and the group's ``weight_names``."""
    root = Tree()
    root.attrs["layer_names"] = np.array([n.encode() for n in layers])
    for lname, weights in layers.items():
        g = root.group(lname)
        wnames = []
        for wn, arr in weights.items():
            full = f"{lname}/{wn}"
            g.dataset(full, arr)
            wnames.append(full.encode())
        g.attrs["weight_names"] = np.array(wnames)
    write_hdf5(path, root)
