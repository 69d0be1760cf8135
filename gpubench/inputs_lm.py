"""The weights of a captioner whose decoder is a language model
(``configs/kimi_vl_a3b_resnet50.json``), made from ``--seed`` on the device:
the encoder's as the caption cells draw theirs (``inputs.make_weights``,
with the configuration's ``served_weight_scales``), and the projector's and
the language model's drawn leaf by leaf in the served dtype, so that no
draw holds more than one leaf and no float32 copy of the 16 B parameters is
ever made. The same seed on the same device gives the same bits, so the
reference regenerates the weights instead of a copy being kept.

The language model's leaves (``lm_weight_scales`` scales some):

* every product's weight, the experts' and the router's too: normal with
  std ``1 / √fan_in``, so that a sublayer's output keeps its input's
  scale; times ``branch`` where the output joins the residual stream
  (``BRANCH_OUT``); ``lm_head``'s times ``lm_head``, which sets how peaked
  the next-token distribution is;
* the token embedding: normal with std ``embedding``. It and ``branch``
  set the residual stream's scale against what each layer adds to it, and
  so how far a rounding in one layer moves the logits;
* norm scales ``1 + 0.1·N``, the projector's biases ``0.1·N``, and the
  router's correction bias ``correction_bias``·N, so that choosing by
  ``s + b`` and by ``s`` differ;
* ``lm_head``'s row of ``<end>`` is 0: its logit is 0 where the best
  candidates lie several std above, so no beam ends and every search runs
  all ``max_seq_len`` steps."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import inputs
from .reference import kimi_vl as ref

END = 3
# the products whose output joins the residual stream: attention's, the MLPs' and the experts'
BRANCH_OUT = ("o_proj.weight", "down_proj.weight", "experts.down_proj")


def reference_model(cfg: dict, device="meta") -> ref.Captioner:
    with torch.device(device):
        return ref.Captioner(cfg)


def _std(key: str, module: nn.Module, name: str, shape, scales: dict) -> tuple[float, float]:
    """``(std, base)`` of a leaf: its value is ``base + std·N(0, 1)``."""
    if isinstance(module, (ref.RMSNorm, nn.LayerNorm)) and name == "weight":
        return 0.1, 1.0
    if name == "bias":
        return 0.1, 0.0
    if name == "e_score_correction_bias":
        return scales["correction_bias"], 0.0
    if isinstance(module, nn.Embedding):
        return scales["embedding"], 0.0
    std = 1.0 / math.sqrt(shape[-1])
    if key.endswith("lm_head.weight"):
        return std * scales["lm_head"], 0.0
    if key.endswith(BRANCH_OUT):
        return std * scales["branch"], 0.0
    return std, 0.0


def lm_specs(cfg: dict) -> list[tuple[str, tuple, float, float]]:
    """``(key, shape, std, base)`` of the projector's and the language
    model's leaves, in the order they are drawn."""
    model = reference_model(cfg)
    scales = cfg["lm_weight_scales"]
    out = []
    for part in ("multi_modal_projector", "language_model"):
        for mname, m in getattr(model, part).named_modules():
            for name, p in m.named_parameters(recurse=False):
                key = ".".join(x for x in (part, mname, name) if x)
                out.append((key, tuple(p.shape), *_std(key, m, name, p.shape, scales)))
    return out


@torch.no_grad()
def lm_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The projector's and the language model's state dict on ``device`` in
    ``dtype``, one leaf a draw of a generator seeded from ``seed``; the
    router's correction bias in float32."""
    g = torch.Generator(device=device).manual_seed(inputs.subseed(seed, 5000))
    state = {}
    for key, shape, std, base in lm_specs(cfg):
        dt = torch.float32 if key.endswith("e_score_correction_bias") else dtype
        t = torch.randn(shape, generator=g, device=device, dtype=dt).mul_(std)
        state[key] = t.add_(base) if base else t
    state["language_model.lm_head.weight"][END] = 0
    return state


def encoder_weights(cfg: dict, seed: int, device) -> dict:
    """The encoder's float32 state dict, as ``inputs.make_weights`` draws the
    caption cells' (its BatchNorm statistics calibrated)."""
    state = inputs.make_weights(cfg, len(inputs.VOCAB_PREFIX), seed, device,
                                scales=cfg["served_weight_scales"])
    return {k: v for k, v in state.items() if k.startswith("encoder.")}


def weights(cfg: dict, seed: int, device, encoder: dict | None = None,
            dtype=torch.bfloat16) -> dict:
    """The whole captioner's state dict, its language model in ``dtype``
    (``encoder``: the encoder's, where already made)."""
    enc = encoder_weights(cfg, seed, device) if encoder is None else encoder
    return {**{k: v.to(device) for k, v in enc.items()}, **lm_weights(cfg, seed, device, dtype)}


def reference(cfg: dict, state: dict, device, numerics=None) -> ref.Captioner:
    """The float32 reference holding ``state`` as it is (the language model
    in its served dtype, each product taking it in float32), its products
    rounded by ``numerics``."""
    from .reference.model import set_numerics

    model = reference_model(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    if numerics is not None:
        set_numerics(model, numerics)
    return model.to(device).eval().requires_grad_(False)
