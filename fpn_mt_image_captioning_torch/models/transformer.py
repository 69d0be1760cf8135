"""Multi-Transformer (UMV multi-view encoder) + decoder (port of
``fpn_mt_image_captioning_tpu/models/transformer.py``), inference only.

  * ``EncoderLayer`` — one cross-attention per non-baseline pyramid view into
    the baseline stream, residual-summed, then post-LN FFN.
  * ``Encoder`` — the five feature views reordered so ``baseline_index`` comes
    last, each flattened to (B, h·w, d_model), normalized by ONE shared
    LayerNorm and given the shared sinusoidal PE sliced to its length; the
    layers update only the baseline slot. Output (B, 16, d_model) at 512².
  * ``Decoder`` — post-LN transformer decoder with an *unscaled* embedding
    (the reference comments out the sqrt(d_model) factor) and LayerNorm
    epsilon 1e-6. Its teacher-forced ``forward`` serves the tests; decoding
    runs through ``ops/fused_decoder.py``.

Module and parameter names mirror the Flax tree (``weights.from_flax``).
Dropout is omitted: nothing here trains yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import MultiHeadAttention, MultiViewAttention
from .feature_extractor import FeatureExtractor
from .layers import LayerNorm32, normalize_images, resolve_activation
from .positional import raw_positional_encoding

__all__ = ["EncoderLayer", "DecoderLayer", "Encoder", "Decoder", "Transformer"]


class _FFN(nn.Module):
    """Dense(dff, act) → Dense(d_model)."""

    def __init__(self, d_model: int, dff: int, activation: str = "leaky_relu"):
        super().__init__()
        self.ffn1 = nn.Linear(d_model, dff)
        self.ffn2 = nn.Linear(dff, d_model)
        self.act = resolve_activation(activation)

    def forward(self, x):
        return self.ffn2(self.act(self.ffn1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dff: int, num_views: int,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.mva = MultiViewAttention(num_views, d_model, num_heads)
        self.ffn = _FFN(d_model, dff, activation)
        self.layernorm1 = LayerNorm32(d_model)
        self.layernorm2 = LayerNorm32(d_model)

    def forward(self, baseline, sources, kv_w, kv_b):
        out1 = self.layernorm1(baseline + self.mva(baseline, sources, kv_w, kv_b))
        return self.layernorm2(out1 + self.ffn(out1))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 input_vocab_size: int, num_pyramids: int = 5, baseline_index: int = 3,
                 backbone_name: str = "mobilenet224_1.0", n_conv_submodule: int = 2,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.num_layers = num_layers
        num_views = num_pyramids - 1
        self.feature_extractor = FeatureExtractor(
            backbone_name, d_model, n_conv_submodule=n_conv_submodule,
            activation=activation,
        )
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, num_heads, dff, num_views, activation))
        # all layers' K/V projections of the (layer-invariant) source views
        self.kv_proj = nn.Parameter(torch.empty(num_layers, num_views, d_model, 2 * d_model))
        self.kv_bias = nn.Parameter(torch.zeros(num_layers, num_views, 2 * d_model))
        self.layernorm1 = LayerNorm32(d_model)  # shared across all views
        self.pos_encoding = raw_positional_encoding(input_vocab_size, d_model)
        # baseline view moved to the back (reference transformer.py:253)
        self.x_order = [i for i in range(num_pyramids) if i != baseline_index] + [baseline_index]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``images``: (B, S, S, 3) uint8 or [-1, 1] float, NHWC as the JAX
        package takes them. Returns (B, Lbaseline, d_model)."""
        dtype = self.kv_proj.dtype
        x = normalize_images(images).permute(0, 3, 1, 2).to(dtype)
        return self.encode_views(self.feature_extractor(x))

    def encode_views(self, views: list[torch.Tensor]) -> torch.Tensor:
        """``views``: the five NCHW feature-extractor outputs."""
        embedded = []
        for i in self.x_order:
            v = views[i]
            t = v.flatten(2).transpose(1, 2)                         # (B, h·w, d)
            pe = torch.as_tensor(self.pos_encoding[: t.shape[1]], device=t.device)
            embedded.append(self.layernorm1(t) + pe.to(t.dtype))
        baseline, sources = embedded[-1], embedded[:-1]
        for li in range(self.num_layers):
            baseline = getattr(self, f"layer_{li}")(
                baseline, sources, self.kv_proj[li], self.kv_bias[li])
        return baseline


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dff: int,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.mha1 = MultiHeadAttention(d_model, num_heads)
        self.mha2 = MultiHeadAttention(d_model, num_heads)
        self.ffn = _FFN(d_model, dff, activation)
        self.layernorm1 = LayerNorm32(d_model)
        self.layernorm2 = LayerNorm32(d_model)
        self.layernorm3 = LayerNorm32(d_model)

    def forward(self, x, enc_output, look_ahead_mask=None, padding_mask=None):
        attn1, w1 = self.mha1(x, x, x, look_ahead_mask)
        out1 = self.layernorm1(attn1 + x)
        attn2, w2 = self.mha2(out1, enc_output, enc_output, padding_mask)
        out2 = self.layernorm2(attn2 + out1)
        return self.layernorm3(self.ffn(out2) + out2), w1, w2


class Decoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 target_vocab_size: int, max_position: int = 0, max_seq_len: int = 12,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Embedding(target_vocab_size, d_model)
        self.pos_encoding = raw_positional_encoding(max_seq_len + max_position, d_model)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, num_heads, dff, activation))

    def forward(self, x: torch.Tensor, enc_output: torch.Tensor,
                look_ahead_mask: Optional[torch.Tensor] = None,
                padding_mask: Optional[torch.Tensor] = None):
        """Teacher-forced decode of (B, L) token ids; returns the hidden states
        and the per-layer attention weights under the reference's names."""
        h = self.embedding(x)  # unscaled — reference parity
        pe = torch.as_tensor(self.pos_encoding[: x.shape[1]], device=h.device)
        h = h + pe.to(h.dtype)
        attention_weights = {}
        for i in range(self.num_layers):
            h, w1, w2 = getattr(self, f"layer_{i}")(h, enc_output, look_ahead_mask, padding_mask)
            attention_weights[f"decoder_layer{i + 1}_block1"] = w1
            attention_weights[f"decoder_layer{i + 1}_block2"] = w2
        return h, attention_weights


class Transformer(nn.Module):
    """Top-level seq2seq model. ``encode`` serves the captioning path;
    ``forward`` is the teacher-forced decoder over a precomputed encoder
    output (the reference's inference calling contract)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 input_vocab_size: int, target_vocab_size: int, max_position: int = 0,
                 max_seq_len: int = 12, num_pyramids: int = 5, baseline_index: int = 3,
                 backbone_name: str = "mobilenet224_1.0", n_conv_submodule: int = 2,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.num_layers, self.d_model, self.num_heads = num_layers, d_model, num_heads
        self.max_seq_len, self.max_position = max_seq_len, max_position
        self.activation = activation
        self.encoder = Encoder(
            num_layers, d_model, num_heads, dff, input_vocab_size, num_pyramids,
            baseline_index, backbone_name, n_conv_submodule, activation,
        )
        self.decoder = Decoder(
            num_layers, d_model, num_heads, dff, target_vocab_size, max_position,
            max_seq_len, activation,
        )
        self.final_layer = nn.Linear(d_model, target_vocab_size)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def forward(self, enc_output: torch.Tensor, tar: torch.Tensor,
                look_ahead_mask: Optional[torch.Tensor] = None):
        dec_output, attention_weights = self.decoder(tar, enc_output, look_ahead_mask)
        return self.final_layer(dec_output).float(), attention_weights
