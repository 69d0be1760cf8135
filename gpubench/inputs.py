"""Everything a run feeds the captioner, made from ``--seed``: the weights
(drawn on the device in a few large calls, in float32, handed to the
captioner and to the reference alike), the vocabulary, the images and the
captions. Nothing here imports the captioner."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .reference import model as ref

VOCAB_PREFIX = ("", "unk", "<start>", "<end>")   # ids 0-3; words fill the rest


def reference_model(cfg: dict, vocab: int, device="meta") -> ref.Transformer:
    """The plain model of ``cfg`` on ``device`` (uninitialized)."""
    with torch.device(device):
        return ref.Transformer(cfg, vocab, cfg["max_seq_len"])


def _leaf_specs(model: nn.Module, scales: dict):
    """``(key, shape, std, base, uniform)`` of every parameter and statistic:
    the value is ``base + std·N(0, 1)``, or ``base + U(0, 1)`` when
    ``uniform``. Kernels take the captioner's initializer families (lecun
    for the backbone, glorot for the FPN and the vocabulary layer, 0.01 for
    the head trunks, he elsewhere) as normals of the same variance; biases,
    norm offsets and running means are moved off 0 by 0.1·N, norm scales off
    1 by 0.1·N and running variances drawn from U(0.5, 1.5), so that no
    layer is an identity. ``scales`` multiplies the head trunks
    (``trunk``), the token embedding (``embedding``) and the vocabulary
    layer (``vocab``)."""
    out = []
    for name, m in model.named_modules():
        part = name.split(".")
        for pname, t in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            key = f"{name}.{pname}" if name else pname
            shape = tuple(t.shape)
            if pname == "running_var":
                out.append((key, shape, 0.0, 0.5, True))
            elif pname == "running_mean" or pname in ("bias", "bq", "bo", "kv_bias"):
                out.append((key, shape, 0.1, 0.0, False))
            elif isinstance(m, (nn.LayerNorm, ref.BatchNorm)):
                out.append((key, shape, 0.1, 1.0, False))
            elif isinstance(m, nn.Conv2d):
                fan_in = math.prod(shape[1:])
                if "backbone" in part:
                    std = math.sqrt(1.0 / fan_in)
                elif "fpn" in part:
                    std = math.sqrt(2.0 / (fan_in + shape[0] * math.prod(shape[2:])))
                elif "regression_trunk" in part or "classification_trunk" in part:
                    std = 0.01 * scales.get("trunk", 1.0)
                else:
                    std = math.sqrt(2.0 / fan_in)
                out.append((key, shape, std, 0.0, False))
            elif isinstance(m, nn.Linear):
                if name == "final_layer":
                    std = math.sqrt(2.0 / sum(shape)) * scales.get("vocab", 1.0)
                else:
                    std = math.sqrt(2.0 / shape[1])
                out.append((key, shape, std, 0.0, False))
            elif isinstance(m, nn.Embedding):
                out.append((key, shape, 0.05 / math.sqrt(3.0) * scales.get("embedding", 1.0),
                            0.0, False))
            else:   # the multi-view stacks (in, out) and the encoder's K/V stack
                out.append((key, shape, math.sqrt(2.0 / shape[-2]), 0.0, False))
    return out


@torch.no_grad()
def make_weights(cfg: dict, vocab: int, seed: int, device, scales: dict | None = None,
                 end_id: int | None = None, end_bias: float | None = None) -> dict:
    """The float32 state dict of ``cfg``'s model on ``device``, from one
    normal and one uniform draw of a generator on ``device`` seeded with
    ``seed``. ``end_bias`` sets the vocabulary layer's bias of ``end_id``."""
    specs = _leaf_specs(reference_model(cfg, vocab), scales or {})
    g = torch.Generator(device=device).manual_seed(seed)
    n_norm = sum(math.prod(s) for _, s, _, _, u in specs if not u)
    n_unif = sum(math.prod(s) for _, s, _, _, u in specs if u)
    normal = torch.randn(n_norm, generator=g, device=device)
    uniform = torch.rand(n_unif, generator=g, device=device)
    state, on, ou = {}, 0, 0
    for key, shape, std, base, unif in specs:
        n = math.prod(shape)
        if unif:
            state[key] = (uniform[ou:ou + n] + base).view(shape)
            ou += n
        else:
            state[key] = (normal[on:on + n] * std + base).view(shape)
            on += n
    if end_bias is not None:
        state["final_layer.bias"][end_id] = end_bias
    calibrate(state, cfg, vocab, seed, device)
    return state


def calibrate(state: dict, cfg: dict, vocab: int, seed: int, device, n: int = 4) -> None:
    """Give the backbone's BatchNorm statistics a trained model's scale: the
    float32 reference's backbone runs once in training mode at momentum 0
    on ``n`` seeded images, so each running mean and variance is the
    batch's; the variance drawn above (U(0.5, 1.5)) is then added to it, so
    that no channel divides by the root of a variance near 0. Without this
    a deep backbone's activations grow into the hundreds in inference."""
    model = reference_model(cfg, vocab, device)
    model.load_state_dict(state)
    bns = [(name, m) for name, m in model.named_modules() if isinstance(m, ref.BatchNorm)]
    size = cfg["image_input_size"]
    g = torch.Generator(device=device).manual_seed(subseed(seed, 3000))
    x = torch.rand((n, 3, size, size), generator=g, device=device) * 2 - 1
    with exact_float32():
        for _, m in bns:
            m.momentum = 0.0
        model.encoder.feature_extractor.backbone(x, train=True)
    for name, m in bns:
        state[f"{name}.running_mean"] = m.running_mean.detach()
        state[f"{name}.running_var"] = m.running_var.detach() + state[f"{name}.running_var"]


class exact_float32:
    """Float32 products without TF32 inside the block; the settings the
    process had are restored after it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.is_grad_enabled())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.set_grad_enabled(False)

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         grad) = self.saved
        torch.set_grad_enabled(grad)


def _flax_names(cfg: dict, vocab: int):
    """For each state-dict key of ``cfg``'s model: its collection, its path
    in the weight file's tree, the change of layout that takes it there
    (kernels (in, out) and HWIO; norm weights ``scale``; statistics
    ``mean``/``var``; the embedding ``embedding``) and the change back."""
    model = reference_model(cfg, vocab)
    modules = dict(model.named_modules())
    keep = lambda t: t
    for key in model.state_dict():
        mod, _, name = key.rpartition(".")
        m, col, move, back = modules[mod], "params", keep, keep
        if name in ("running_mean", "running_var"):
            col, name = "batch_stats", name[len("running_"):]
        elif name == "weight":
            if isinstance(m, nn.Conv2d):
                name = "kernel"
                move, back = lambda t: t.permute(2, 3, 1, 0), lambda t: t.permute(3, 2, 0, 1)
            elif isinstance(m, nn.Linear):
                name, move, back = "kernel", lambda t: t.T, lambda t: t.T
            else:
                name = "embedding" if isinstance(m, nn.Embedding) else "scale"
        yield key, col, [*mod.split("."), name], move, back


def flax_tree(state: dict, cfg: dict, vocab: int) -> dict:
    """``state`` as the captioner's weight files lay it out (``{"params",
    "batch_stats"}`` of numpy arrays)."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, col, path, move, _ in _flax_names(cfg, vocab):
        node = tree[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(move(state[key]).detach().cpu().numpy())
    return tree


def state_dict(tree: dict, cfg: dict, vocab: int) -> dict:
    """The inverse of ``flax_tree`` for the collections ``tree`` holds: a
    float32 state dict (of the parameters alone for ``{"params": ...}``)."""
    out = {}
    for key, col, path, _, back in _flax_names(cfg, vocab):
        if col in tree:
            node = tree[col]
            for p in path:
                node = node[p]
            out[key] = back(torch.as_tensor(np.asarray(node, np.float32))).contiguous()
    return out


def flax_paths(cfg: dict, vocab: int) -> dict[str, str]:
    """The weight-file path (``a/b/kernel``) of each parameter's key."""
    return {key: "/".join(path) for key, col, path, _, _ in _flax_names(cfg, vocab)
            if col == "params"}


def leaves(tree: dict, prefix: str = ""):
    """``(path, array)`` of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def vocabulary(size: int) -> list[str]:
    """The ``size`` words of the synthetic vocabulary, ids 0-3 first."""
    return list(VOCAB_PREFIX) + [f"w{i}" for i in range(size - len(VOCAB_PREFIX))]


def images(n: int, size: int, seed: int, device) -> np.ndarray:
    """``n`` uint8 (size, size, 3) images, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def captions(n: int, max_len: int, vocab: int, lengths: tuple[int, int],
             rng: np.random.Generator) -> np.ndarray:
    """``n`` caption rows as the dataset pads them: ``<start>``, words,
    ``<end>``, zeros; lengths (with both markers) uniform in ``lengths``."""
    rows = np.zeros((n, max_len), np.int32)
    for row, k in zip(rows, rng.integers(lengths[0], lengths[1] + 1, n)):
        row[0], row[k - 1] = 2, 3
        row[1:k - 1] = rng.integers(len(VOCAB_PREFIX), vocab, k - 2)
    return rows


def subseed(seed: int, tag: int) -> int:
    """A seed of its own for the ``tag``-th draw of a run."""
    return (seed * 1_000_003 + tag * 7919) % (2**62)
