"""Multi-Transformer (UMV multi-view encoder) + decoder (port of
``fpn_mt_image_captioning_tpu/models/transformer.py``).

  * ``EncoderLayer`` — one cross-attention per non-baseline pyramid view into
    the baseline stream, residual-summed, then post-LN FFN.
  * ``Encoder`` — the five feature views reordered so ``baseline_index`` comes
    last, each flattened to (B, h·w, d_model), normalized by ONE shared
    LayerNorm and given the shared sinusoidal PE sliced to its length; the
    layers update only the baseline slot. Output (B, 16, d_model) at 512².
  * ``Decoder`` — post-LN transformer decoder with an *unscaled* embedding
    (the reference comments out the sqrt(d_model) factor) and LayerNorm
    epsilon 1e-6. Its teacher-forced ``forward`` gives the attention
    read-out; ``init_cache``/``decode_step`` are the non-fused KV-cached
    step (parity-mode and greedy beam search, sampling); the fast beam
    search runs ``ops/fused_decoder.py``.

Module and parameter names mirror the Flax tree (``weights.from_flax``).

Training (``Transformer.forward_train``, the JAX ``__call__(inp, tar,
training=True, mask)``): the encoder runs on the images with BatchNorm in
training mode, then the decoder, with dropout at the JAX package's sites,
each named for its mask (``layers.Dropout``): each embedded view, each
multi-view attention output before the sum, the encoder FFN output, the
decoder embedding after the PE, and a decoder layer's two attention outputs
and FFN output. ``compute_dtype`` is the dtype the dense layers, convs and
embedding compute in (None: the weights' own, as after
``decode.beam_search.cast_for_inference``); LayerNorm, BatchNorm and softmax
compute in float32 and the logits come out float32. ``remat_encoder`` runs
each encoder layer under ``torch.utils.checkpoint`` while gradients are
recorded.

Tensor parallelism (``parallel.train.shard_state``): each module whose
weights are sharded over the model group holds its group and its shard —
the attentions their heads, the FFN its slice of dff, the final layer its
slice of the vocabulary, the encoder its columns of the K/V stack — and
issues the collectives of the Megatron rules itself
(``parallel.collectives``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import gather_shards, replicated_input
from ..utils.profiling import annotate
from .attention import MultiHeadAttention, MultiViewAttention
from .feature_extractor import FeatureExtractor
from .layers import Dense, Dropout, LayerNorm32, dropout, normalize_images, resolve_activation
from .positional import raw_positional_encoding

__all__ = ["EncoderLayer", "DecoderLayer", "Encoder", "Decoder", "Transformer"]


class _FFN(nn.Module):
    """Dense(dff, act) → Dense(d_model); under tensor parallelism
    (``tp_group``) ``ffn1`` column-parallel over dff and ``ffn2``
    row-parallel."""

    tp_group = None

    def __init__(self, d_model: int, dff: int, activation: str = "leaky_relu"):
        super().__init__()
        self.ffn1 = Dense(d_model, dff)
        self.ffn2 = Dense(dff, d_model)
        self.act = resolve_activation(activation)

    def forward(self, x):
        if self.tp_group is not None:
            x = replicated_input(x, self.tp_group)
        return self.ffn2(self.act(self.ffn1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dff: int, num_views: int,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.mva = MultiViewAttention(num_views, d_model, num_heads)
        self.ffn = _FFN(d_model, dff, activation)
        self.layernorm1 = LayerNorm32(d_model)
        self.layernorm2 = LayerNorm32(d_model)

    def forward(self, baseline, sources, kv_w, kv_b, drop: Dropout | None = None,
                site: str = "encoder.layer"):
        out1 = self.layernorm1(
            baseline + self.mva(baseline, sources, kv_w, kv_b, drop, f"{site}.mva"))
        ffn_out = dropout(self.ffn(out1), drop, f"{site}.dropout2")
        return self.layernorm2(out1 + ffn_out)


class Encoder(nn.Module):
    # under tensor parallelism the group over which kv_proj/kv_bias are
    # sharded: gathered whole once a forward, each layer takes its heads
    kv_group = None

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 input_vocab_size: int, num_pyramids: int = 5, baseline_index: int = 3,
                 backbone_name: str = "mobilenet224_1.0", n_conv_submodule: int = 2,
                 activation: str = "leaky_relu", remat: bool = False,
                 bn_momentum: float | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_layers, self.remat, self.compute_dtype = num_layers, remat, compute_dtype
        num_views = num_pyramids - 1
        self.feature_extractor = FeatureExtractor(
            backbone_name, d_model, n_conv_submodule=n_conv_submodule,
            activation=activation, bn_momentum=bn_momentum,
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

    def forward(self, images: torch.Tensor, train: bool = False,
                drop: Dropout | None = None) -> torch.Tensor:
        """``images``: (B, S, S, 3) uint8 or [-1, 1] float, NHWC as the JAX
        package takes them. Returns (B, Lbaseline, d_model)."""
        return self.encode_views(self.features(images, train), drop)

    def features(self, images: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        """The five views of (B, S, S, 3) ``images``, in the compute dtype."""
        dtype = self.compute_dtype or self.kv_proj.dtype
        x = normalize_images(images).permute(0, 3, 1, 2).to(dtype)
        return self.feature_extractor(x, train)

    def from_taps(self, c3: torch.Tensor, c4: torch.Tensor, c5: torch.Tensor) -> torch.Tensor:
        """Encode from precomputed NHWC backbone taps (the fused-backbone
        serving path, ``ops/fused_backbone.py``)."""
        return self.encode_views(self.feature_extractor.from_taps(c3, c4, c5))

    def encode_views(self, views: list[torch.Tensor],
                     drop: Dropout | None = None) -> torch.Tensor:
        """``views``: the five NCHW feature-extractor outputs."""
        embedded = []
        for k, i in enumerate(self.x_order):
            v = views[i]
            t = v.flatten(2).transpose(1, 2)                         # (B, h·w, d)
            # a copy from host memory: it waits for the card's queued work
            with annotate("model.pe_upload", wait=True):
                pe = torch.as_tensor(self.pos_encoding[: t.shape[1]], device=t.device)
            t = self.layernorm1(t) + pe.to(t.dtype)
            embedded.append(dropout(t, drop, f"encoder.dropout1_{k}"))
        baseline, sources = embedded[-1], embedded[:-1]
        kv_proj, kv_bias = self.kv_proj, self.kv_bias
        if self.kv_group is not None:
            kv_proj = gather_shards(kv_proj, self.kv_group, -1, sum_grad=True)
            kv_bias = gather_shards(kv_bias, self.kv_group, -1, sum_grad=True)
        for li in range(self.num_layers):
            args = (baseline, sources, kv_proj[li], kv_bias[li], drop,
                    f"encoder.layer_{li}")
            layer = getattr(self, f"layer_{li}")
            if self.remat and torch.is_grad_enabled():
                baseline = checkpoint(layer, *args, use_reentrant=False)
            else:
                baseline = layer(*args)
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

    def forward(self, x, enc_output, look_ahead_mask=None, padding_mask=None,
                drop: Dropout | None = None, site: str = "decoder.layer"):
        attn1, w1 = self.mha1(x, x, x, look_ahead_mask)
        out1 = self.layernorm1(dropout(attn1, drop, f"{site}.dropout1") + x)
        attn2, w2 = self.mha2(out1, enc_output, enc_output, padding_mask)
        out2 = self.layernorm2(dropout(attn2, drop, f"{site}.dropout2") + out1)
        ffn_out = dropout(self.ffn(out2), drop, f"{site}.dropout3")
        return self.layernorm3(ffn_out + out2), w1, w2

    def decode_step(self, x_t, pos: int, k_self, v_self, k_cross, v_cross, src=None):
        """One position: writes the new K/V row at ``pos`` (in place; the
        caches are returned), masks the slots after ``pos``, then
        self-attention through the ancestry ``src``, cross-attention and the
        FFN, each post-LN. ``x_t`` (B, 1, d); caches (B, L, H, D)."""
        k_t, v_t = self.mha1.project_kv(x_t)
        k_self[:, pos], v_self[:, pos] = k_t[:, 0], v_t[:, 0]
        idx = torch.arange(k_self.shape[1], device=x_t.device)
        self_mask = (idx > pos).float()[None, :, None]
        out1 = self.layernorm1(
            self.mha1.attend_cached(x_t, k_self, v_self, mask=self_mask, src=src) + x_t)
        out2 = self.layernorm2(self.mha2.attend_cached(out1, k_cross, v_cross) + out1)
        return self.layernorm3(self.ffn(out2) + out2), k_self, v_self


class Decoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 target_vocab_size: int, max_position: int = 0, max_seq_len: int = 12,
                 activation: str = "leaky_relu", compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_layers, self.compute_dtype = num_layers, compute_dtype
        self.embedding = nn.Embedding(target_vocab_size, d_model)
        self.pos_encoding = raw_positional_encoding(max_seq_len + max_position, d_model)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, num_heads, dff, activation))

    def forward(self, x: torch.Tensor, enc_output: torch.Tensor,
                look_ahead_mask: Optional[torch.Tensor] = None,
                padding_mask: Optional[torch.Tensor] = None, drop: Dropout | None = None):
        """Teacher-forced decode of (B, L) token ids; returns the hidden states
        and the per-layer attention weights under the reference's names."""
        h = self.embedding(x)  # unscaled — reference parity
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        with annotate("model.pe_upload", wait=True):
            pe = torch.as_tensor(self.pos_encoding[: x.shape[1]], device=h.device)
        h = dropout(h + pe.to(h.dtype), drop, "decoder.dropout")
        attention_weights = {}
        for i in range(self.num_layers):
            h, w1, w2 = getattr(self, f"layer_{i}")(h, enc_output, look_ahead_mask, padding_mask,
                                                    drop, f"decoder.layer_{i}")
            attention_weights[f"decoder_layer{i + 1}_block1"] = w1
            attention_weights[f"decoder_layer{i + 1}_block2"] = w2
        return h, attention_weights

    def init_cache(self, enc_output: torch.Tensor, max_len: int) -> list[dict]:
        """Per layer: zero self-attention K/V of length ``max_len`` and the
        cross-attention K/V projected once from ``enc_output``, all in its
        dtype."""
        b = enc_output.shape[0]
        cache = []
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            k_cross, v_cross = layer.mha2.project_kv(enc_output)
            shape = (b, max_len, layer.mha1.num_heads, layer.mha1.depth)
            cache.append({"k_self": enc_output.new_zeros(shape),
                          "v_self": enc_output.new_zeros(shape),
                          "k_cross": k_cross, "v_cross": v_cross})
        return cache

    def decode_step(self, tokens: torch.Tensor, pos: int, cache: list[dict], src=None):
        """(B,) token ids at position ``pos`` → the (B, d) hidden state; the
        self caches are written in place and returned in ``cache``."""
        h = self.embedding(tokens)[:, None, :]
        with annotate("model.pe_upload", wait=True):
            pe = torch.as_tensor(self.pos_encoding[pos], device=h.device)
        h = h + pe.to(h.dtype)
        for i, c in enumerate(cache):
            h, c["k_self"], c["v_self"] = getattr(self, f"layer_{i}").decode_step(
                h, pos, c["k_self"], c["v_self"], c["k_cross"], c["v_cross"], src)
        return h[:, 0], cache


class Transformer(nn.Module):
    """Top-level seq2seq model. ``encode`` serves the captioning path;
    ``forward`` is the teacher-forced decoder over a precomputed encoder
    output (the reference's inference calling contract); ``forward_train``
    the training forward from the images; ``init_cache`` and ``decode_step``
    the non-fused KV-cached decode. Under tensor parallelism
    (``vocab_group``) the final layer holds this rank's slice of the
    vocabulary, and ``forward_train`` gathers the logits whole before the
    loss."""

    vocab_group = None

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dff: int,
                 input_vocab_size: int, target_vocab_size: int, max_position: int = 0,
                 max_seq_len: int = 12, num_pyramids: int = 5, baseline_index: int = 3,
                 backbone_name: str = "mobilenet224_1.0", n_conv_submodule: int = 2,
                 activation: str = "leaky_relu", remat_encoder: bool = False,
                 bn_momentum: float | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_layers, self.d_model, self.num_heads = num_layers, d_model, num_heads
        self.max_seq_len, self.max_position = max_seq_len, max_position
        self.activation = activation
        self.encoder = Encoder(
            num_layers, d_model, num_heads, dff, input_vocab_size, num_pyramids,
            baseline_index, backbone_name, n_conv_submodule, activation, remat_encoder,
            bn_momentum, compute_dtype,
        )
        self.decoder = Decoder(
            num_layers, d_model, num_heads, dff, target_vocab_size, max_position,
            max_seq_len, activation, compute_dtype,
        )
        self.final_layer = Dense(d_model, target_vocab_size)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def encode_from_taps(self, c3: torch.Tensor, c4: torch.Tensor, c5: torch.Tensor) -> torch.Tensor:
        return self.encoder.from_taps(c3, c4, c5)

    def forward(self, enc_output: torch.Tensor, tar: torch.Tensor,
                look_ahead_mask: Optional[torch.Tensor] = None):
        dec_output, attention_weights = self.decoder(tar, enc_output, look_ahead_mask)
        return self.final_layer(dec_output).float(), attention_weights

    def forward_train(self, images: torch.Tensor, tar: torch.Tensor,
                      look_ahead_mask: Optional[torch.Tensor] = None,
                      drop: Dropout | None = None):
        """The training forward: the encoder on ``images`` with BatchNorm in
        training mode (its running statistics updated in place), then the
        decoder, both dropped out by ``drop`` (None: no dropout). Returns
        float32 logits (B, L, V) and the attention weights."""
        enc_output = self.encoder(images, train=True, drop=drop)
        dec_output, attention_weights = self.decoder(tar, enc_output, look_ahead_mask, None,
                                                     drop)
        g = self.vocab_group
        if g is None:
            return self.final_layer(dec_output).float(), attention_weights
        logits = self.final_layer(replicated_input(dec_output, g))
        return gather_shards(logits, g, -1).float(), attention_weights

    def init_cache(self, enc_output: torch.Tensor, max_len: int) -> list[dict]:
        return self.decoder.init_cache(enc_output, max_len)

    def decode_step(self, tokens: torch.Tensor, pos: int, cache: list[dict], src=None):
        """Float32 (B, V) logits of the next token, and the cache."""
        h, cache = self.decoder.decode_step(tokens, pos, cache, src)
        return self.final_layer(h).float(), cache
