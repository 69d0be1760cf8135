"""An image captioner whose decoder is Kimi-VL-A3B's language model: the
FPN-MT encoder (``transformer.Encoder``, (B, 16, d_model) at 512²) in
MoonViT's place, Kimi-VL's MLP projector, and a DeepSeek-V3-style language
model with multi-head latent attention (MLA) and a mixture of experts (MoE),
built from the published ``text_config`` of
``moonshotai/Kimi-VL-A3B-Instruct`` (``Config.language_model``). The JAX
package has no counterpart.

The equations (names as in the published modelling code):

* projector (merge kernel 1×1): ``LayerNorm(d_model, eps 1e-5) → Linear
  (d_model → d_model) → GELU → Linear(d_model → hidden)``, with biases;
* the sequence ``[v_0 … v_15, <start>, w_1 …]`` at positions 0, 1, 2, …
  (1-D RoPE), causal over the whole of it, no chat template;
* a layer: ``h += Attn(RMSNorm(h))``, then ``h += FFN(RMSNorm(h))``; after
  the last, ``RMSNorm`` and ``lm_head`` (no bias). RMSNorm computes in
  float32; the residual stream is kept in float32, the products run in the
  compute dtype;
* MLA: ``q = W_q h`` split per head into ``q_nope`` (128) and ``q_pe``
  (64); ``[c, k_pe] = W_kva h``, ``c`` (512) normalised by its RMSNorm and
  ``k_pe`` (64) shared by the heads; ``[k_nope, v] = W_kvb c`` per head;
  RoPE on ``q_pe`` and ``k_pe`` as the published code lays it out (the
  pairs de-interleaved, ``(d/2, 2) → (2, d/2)``, then rotate-half); scores
  ``(q_nope·k_nope + q_pe·k_pe) · (nope + rope)^-1/2``, softmax in float32,
  then ``W_o`` over the heads' ``v``;
* MoE (layers ``first_k_dense_replace`` on): ``s = sigmoid(W_r h)`` in
  float32; the top ``num_experts_per_tok`` by ``s + b`` (``b`` the
  ``e_score_correction_bias``); their weights ``s``, normalised to sum 1
  and times ``routed_scaling_factor``; ``y = Σ w_i E_i(h) + S(h)`` with
  ``E_i(h) = W_down(silu(W_gate h) ⊙ W_up h)`` and ``S`` the shared experts
  as one such MLP of ``n_shared_experts`` × the expert width. No token is
  dropped. The experts run as one grouped product over all of them
  (``torch._grouped_mm`` with each expert's row offsets): no loop over
  experts and no host synchronisation;
* the dense layers: the same MLP at ``intermediate_size``.

The cache (``init_beam_cache``): the 16 visual tokens and ``<start>`` run
once an image (the ``lm.prefill`` span, non-absorbed attention), which
leaves each layer's prefix rows — ``c`` normalised and ``k_pe`` roped, 576
values a position — once an image, the logits after ``<start>``, and an
empty latent cache of ``length`` slots a decode row. ``decode_step(tokens,
pos, cache, src)`` keeps the non-fused step's contract
(``decode.beam_search._CachedBeams``): step 0 returns the prefix's logits
(its ``<start>`` is already read); step ``pos`` ≥ 1 runs ``tokens`` at
sequence position ``prefix - 1 + pos``, writes each row's latent at slot
``pos`` and reads its ancestors' at slots ``1 … pos`` through ``src`` (B·beam,
length) global rows, and every row of an item reads the item's prefix.
Decode uses the absorbed form: ``q_nope W_UK`` against ``c`` and ``(Σ p c)
W_UV``, ``W_UK`` and ``W_UV`` being the halves of ``W_kvb``.

The MoE layers tally the rows each expert computed (``utils.profiling``'s
counters ``moe.rows`` in decode steps and ``moe.prefill_rows`` in the
prefill, tables of layers × experts on the card)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import REGISTRY, annotate
from .layers import LayerNorm32
from .transformer import Encoder

__all__ = ["TEXT_CONFIG_KEYS", "CaptionLM", "LanguageModel", "Router", "Experts", "MoE",
           "RMSNorm", "rope_tables", "apply_rope", "language_model_parameters"]

# the keys of the published ``text_config`` that ``Config.language_model`` holds
TEXT_CONFIG_KEYS = (
    "vocab_size", "max_position_embeddings", "hidden_size", "intermediate_size",
    "moe_intermediate_size", "num_hidden_layers", "num_attention_heads", "n_shared_experts",
    "n_routed_experts", "ep_size", "routed_scaling_factor", "kv_lora_rank", "q_lora_rank",
    "qk_rope_head_dim", "v_head_dim", "qk_nope_head_dim", "topk_method", "n_group",
    "topk_group", "num_experts_per_tok", "moe_layer_freq", "first_k_dense_replace",
    "norm_topk_prob", "scoring_func", "seq_aux", "num_key_value_heads", "hidden_act",
    "rms_norm_eps", "rope_theta", "rope_scaling", "attention_bias", "tie_word_embeddings")


def _check_config(tc: dict) -> None:
    """Refuse what the equations above do not cover."""
    missing = [k for k in TEXT_CONFIG_KEYS if k not in tc]
    if missing:
        raise ValueError(f"language_model lacks {missing}")
    unsupported = {
        "q_lora_rank": tc["q_lora_rank"] is not None, "rope_scaling": tc["rope_scaling"] is not None,
        "scoring_func": tc["scoring_func"] != "sigmoid", "topk_method": tc["topk_method"] != "noaux_tc",
        "n_group": tc["n_group"] != 1 or tc["topk_group"] != 1, "hidden_act": tc["hidden_act"] != "silu",
        "moe_layer_freq": tc["moe_layer_freq"] != 1, "attention_bias": tc["attention_bias"],
        "tie_word_embeddings": tc["tie_word_embeddings"],
        "num_key_value_heads": tc["num_key_value_heads"] != tc["num_attention_heads"]}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"language_model: {bad} differ from Kimi-VL-A3B's")


class RMSNorm(nn.Module):
    """``x / rms(x) · weight``, computed in float32; the result in ``dtype``
    (default the input's)."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps) * self.weight.float()
        return y.to(dtype or x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """Float32 ``(cos, sin)`` (n, dim) of ``positions`` (n,): frequencies
    ``theta^(-2i/dim)``, each repeated over the two halves."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device, dtype=torch.float32) / dim)
    f = positions.float()[:, None] * inv[None, :]
    f = torch.cat([f, f], -1)
    return f.cos(), f.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE as the published modelling code applies it: the pairs of the last
    axis de-interleaved ((d/2, 2) → (2, d/2)), then ``x cos + rotate_half(x)
    sin`` in float32; the result in ``x``'s dtype. ``cos``/``sin`` broadcast
    against ``x``."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = xf.chunk(2, -1)
    return (xf * cos + torch.cat([-x2, x1], -1) * sin).to(x.dtype)


class LatentAttention(nn.Module):
    """MLA without a query low-rank (``q_lora_rank`` null)."""

    def __init__(self, tc: dict):
        super().__init__()
        d, h = tc["hidden_size"], tc["num_attention_heads"]
        self.heads, self.rank = h, tc["kv_lora_rank"]
        self.nope, self.rope, self.v = tc["qk_nope_head_dim"], tc["qk_rope_head_dim"], tc["v_head_dim"]
        self.scale = (self.nope + self.rope) ** -0.5
        self.q_proj = nn.Linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, tc["rms_norm_eps"])
        self.kv_b_proj = nn.Linear(self.rank, h * (self.nope + self.v), bias=False)
        self.o_proj = nn.Linear(h * self.v, d, bias=False)

    def latents(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        """``[RMSNorm(c), rope(k_pe)]`` (…, rank + rope) of normed ``x``."""
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], -1)
        return torch.cat([self.kv_a_layernorm(c), apply_rope(k_pe, cos, sin)], -1)

    def queries(self, x: torch.Tensor, cos, sin):
        """``q_nope`` (…, H, nope) and roped ``q_pe`` (…, H, rope)."""
        q = self.q_proj(x).unflatten(-1, (self.heads, self.nope + self.rope))
        q_nope, q_pe = q.split([self.nope, self.rope], -1)
        return q_nope, apply_rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))

    def _halves(self):
        """``W_UK`` (H, nope, rank) and ``W_UV`` (H, v, rank): views of
        ``W_kvb``, the absorbed weights."""
        w = self.kv_b_proj.weight.unflatten(0, (self.heads, self.nope + self.v))
        return w[:, : self.nope], w[:, self.nope:]

    def prefill(self, x: torch.Tensor, cos, sin):
        """Causal attention over (B, n, hidden) normed ``x``, K/V decompressed
        from the latents; returns the output and the latents (B, n, 576)."""
        lat = self.latents(x, cos, sin)
        q_nope, q_pe = self.queries(x, cos, sin)
        kv = self.kv_b_proj(lat[..., : self.rank]).unflatten(-1, (self.heads, self.nope + self.v))
        k_nope, v = kv.split([self.nope, self.v], -1)
        k_pe = lat[..., self.rank:]
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe)).float() * self.scale
        n = x.shape[1]
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
        p = torch.softmax(scores.masked_fill(causal, float("-inf")), -1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).flatten(-2)
        return self.o_proj(out), lat

    def decode(self, x: torch.Tensor, cos, sin, prefix: torch.Tensor, cache: torch.Tensor,
               pos: int, src: torch.Tensor | None) -> torch.Tensor:
        """One position of (N, hidden) normed ``x`` (N = B·beam rows), absorbed:
        writes the rows' latents at slot ``pos`` of ``cache`` (N, length, 576),
        then attends over the item's ``prefix`` (B, P, 576) and the slots
        ``1 … pos`` of each row's ancestry ``src``."""
        n, b = x.shape[0], prefix.shape[0]
        cache[:, pos] = self.latents(x, cos, sin)
        q_nope, q_pe = self.queries(x, cos, sin)
        w_uk, w_uv = self._halves()
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)   # (N, H, rank)
        q = torch.cat([q_lat, q_pe], -1)                                   # (N, H, 576)
        length, width = cache.shape[1:]
        rows = (src[:, 1: pos + 1] if src is not None
                else torch.arange(n, device=x.device)[:, None].expand(n, pos))
        flat = rows * length + torch.arange(1, pos + 1, device=x.device)
        anc = cache.view(-1, width).index_select(0, flat.reshape(-1)).view(n, pos, width)
        qb = q.reshape(b, -1, q.shape[-1])                                 # (B, beam·H, 576)
        s_pre = torch.bmm(qb, prefix.transpose(1, 2)).view(n, self.heads, -1)
        s_anc = torch.bmm(q, anc.transpose(1, 2))
        p = torch.softmax(torch.cat([s_pre, s_anc], -1).float() * self.scale, -1).to(x.dtype)
        lp = prefix.shape[1]
        o = torch.bmm(p[..., :lp].reshape(b, -1, lp), prefix[..., : self.rank]).view(n, self.heads, -1)
        o = o + torch.bmm(p[..., lp:], anc[..., : self.rank])             # (N, H, rank)
        out = torch.bmm(o.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)
        return self.o_proj(out.flatten(1))


class MLP(nn.Module):
    """``down(silu(gate x) ⊙ up x)``."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """Sigmoid scores in float32, the experts chosen by score plus the
    correction bias (``select``), weighted by their scores normalised and
    scaled. Its weight and bias are served in float32."""

    def __init__(self, tc: dict):
        super().__init__()
        self.top_k, self.scale = tc["num_experts_per_tok"], tc["routed_scaling_factor"]
        self.norm = tc["norm_topk_prob"]
        self.weight = nn.Parameter(torch.empty(tc["n_routed_experts"], tc["hidden_size"]))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(tc["n_routed_experts"]))

    def select(self, s: torch.Tensor) -> torch.Tensor:
        return torch.topk(s + self.e_score_correction_bias.float(), self.top_k, dim=-1).indices

    def forward(self, x: torch.Tensor):
        """(T, hidden) → weights (T, k) float32 and expert ids (T, k)."""
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        ids = self.select(s)
        w = s.gather(-1, ids)
        if self.norm and self.top_k > 1:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * self.scale, ids


class Experts(nn.Module):
    """The routed experts' weights stacked: ``gate_up_proj`` (E, 2·width,
    hidden), the gate's rows first, and ``down_proj`` (E, hidden, width)."""

    def __init__(self, tc: dict):
        super().__init__()
        e, d, w = tc["n_routed_experts"], tc["hidden_size"], tc["moe_intermediate_size"]
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * w, d))
        self.down_proj = nn.Parameter(torch.empty(e, d, w))

    def forward(self, x: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor):
        """Σ_i w_i E_{ids_i}(x) in float32 (T, hidden), and the rows each
        expert computed (E,): the (token, choice) rows sorted by expert, two
        grouped products over every expert's run of rows, then each row put
        back in its place (no atomic sums: the result is the same run to
        run)."""
        t, k = ids.shape
        flat = ids.flatten()
        order = torch.argsort(flat, stable=True)
        # not bincount: on the card it reads the largest id back to the host
        counts = flat.new_zeros(self.gate_up_proj.shape[0]).scatter_add_(0, flat,
                                                                         torch.ones_like(flat))
        offs = counts.cumsum(0).to(torch.int32)
        gate, up = torch._grouped_mm(x[order // k], self.gate_up_proj.transpose(1, 2),
                                     offs=offs).chunk(2, -1)
        ys = torch._grouped_mm(F.silu(gate) * up, self.down_proj.transpose(1, 2), offs=offs)
        y = torch.empty_like(ys)
        y[order] = ys
        return (y.view(t, k, -1).float() * weights[..., None]).sum(1), counts


class MoE(nn.Module):
    def __init__(self, tc: dict, index: int):
        super().__init__()
        self.index, self.layers = index, tc["num_hidden_layers"]
        self.gate = Router(tc)
        self.experts = Experts(tc)
        self.shared_experts = MLP(tc["hidden_size"],
                                  tc["moe_intermediate_size"] * tc["n_shared_experts"])

    def routed(self, x: torch.Tensor, counter: str) -> torch.Tensor:
        """The routed experts' part (float32), the rows tallied into ``counter``."""
        y, counts = self.experts(x, *self.gate(x))
        REGISTRY.tally(counter, counts, self.index, self.layers)
        return y

    def forward(self, x: torch.Tensor, counter: str = "moe.rows") -> torch.Tensor:
        """(…, hidden) → float32 (…, hidden)."""
        flat = x.reshape(-1, x.shape[-1])
        y = self.routed(flat, counter) + self.shared_experts(flat).float()
        return y.view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, tc: dict, index: int):
        super().__init__()
        d, eps = tc["hidden_size"], tc["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = LatentAttention(tc)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.moe = index >= tc["first_k_dense_replace"]
        self.mlp = MoE(tc, index) if self.moe else MLP(d, tc["intermediate_size"])

    def ffn(self, h: torch.Tensor, dtype: torch.dtype, counter: str) -> torch.Tensor:
        x = self.post_attention_layernorm(h, dtype)
        return self.mlp(x, counter) if self.moe else self.mlp(x).float()

    def prefill(self, h: torch.Tensor, cos, sin, dtype: torch.dtype):
        """(B, n, hidden) float32 residual → the same, and the latents."""
        a, lat = self.self_attn.prefill(self.input_layernorm(h, dtype), cos, sin)
        h = h + a.float()
        return h + self.ffn(h, dtype, "moe.prefill_rows"), lat

    def decode(self, h: torch.Tensor, cos, sin, prefix, cache, pos: int, src, dtype):
        a = self.self_attn.decode(self.input_layernorm(h, dtype), cos, sin, prefix, cache, pos, src)
        h = h + a.float()
        return h + self.ffn(h, dtype, "moe.rows")


class LanguageModel(nn.Module):
    def __init__(self, tc: dict):
        super().__init__()
        _check_config(tc)
        d = tc["hidden_size"]
        self.config = dict(tc)
        self.embed_tokens = nn.Embedding(tc["vocab_size"], d)
        self.layers = nn.ModuleList(DecoderLayer(tc, i) for i in range(tc["num_hidden_layers"]))
        self.norm = RMSNorm(d, tc["rms_norm_eps"])
        self.lm_head = nn.Linear(d, tc["vocab_size"], bias=False)

    def rope(self, positions: torch.Tensor):
        return rope_tables(positions, self.config["qk_rope_head_dim"], self.config["rope_theta"])

    def head(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.lm_head(self.norm(h, dtype))


class Projector(nn.Module):
    """Kimi-VL's projector at merge kernel 1×1."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.pre_norm = LayerNorm32(d_in, eps=1e-5)
        self.linear_1 = nn.Linear(d_in, d_in)
        self.linear_2 = nn.Linear(d_in, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(self.pre_norm(x))))


class CaptionLM(nn.Module):
    """The captioner (see the module's docstring). ``encode`` is the FPN-MT
    encoder's; ``init_beam_cache``/``init_cache`` and ``decode_step`` are
    the non-fused decode's interface. Its products run in the weights' dtype
    (``compute_dtype``); the encoder computes in ``compute_dtype`` too."""

    def __init__(self, text_config: dict, *, start_token: int, num_layers: int, d_model: int,
                 num_heads: int, dff: int, input_vocab_size: int, num_pyramids: int = 5,
                 baseline_index: int = 3, backbone_name: str = "resnet50",
                 n_conv_submodule: int = 2, activation: str = "leaky_relu",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.start_token = start_token
        self.encoder = Encoder(num_layers, d_model, num_heads, dff, input_vocab_size,
                               num_pyramids, baseline_index, backbone_name, n_conv_submodule,
                               activation, compute_dtype=compute_dtype)
        self.multi_modal_projector = Projector(d_model, text_config["hidden_size"])
        self.language_model = LanguageModel(text_config)

    @property
    def dtype(self) -> torch.dtype:
        return self.language_model.lm_head.weight.dtype

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    @torch.no_grad()
    def cast_language_model_(self, dtype: torch.dtype) -> "CaptionLM":
        """The projector and the language model in ``dtype``, in place (no copy
        of a weight already in it), but for the projector's LayerNorm and the
        router, whose scores are float32: they stay float32."""
        for part in (self.multi_modal_projector, self.language_model):
            for m in part.modules():
                for name, p in m.named_parameters(recurse=False):
                    keep = isinstance(m, (nn.LayerNorm, Router))
                    p.data = p.data.float() if keep else p.data.to(dtype)
        return self

    @torch.no_grad()
    def init_beam_cache(self, enc_output: torch.Tensor, beam: int, length: int) -> dict:
        """Prefill ``[projector(enc_output), <start>]`` once an image, for
        ``beam`` decode rows an image and ``length`` slots a row."""
        lm, dt = self.language_model, self.dtype
        b, dev = enc_output.shape[0], enc_output.device
        with annotate("lm.prefill", device=dev):
            start = torch.full((b, 1), self.start_token, dtype=torch.long, device=dev)
            x = torch.cat([self.multi_modal_projector(enc_output.to(dt)), lm.embed_tokens(start)], 1)
            n = x.shape[1]
            cos, sin = lm.rope(torch.arange(n, device=dev))
            h, prefix = x.float(), []
            for layer in lm.layers:
                h, lat = layer.prefill(h, cos, sin, dt)
                prefix.append(lat)
            logits = lm.head(h[:, -1], dt)
        rows, width = b * beam, prefix[0].shape[-1]
        return {"prefix": prefix, "logits": logits, "beam": beam,
                "latents": [x.new_empty((rows, length, width)) for _ in prefix]}

    def init_cache(self, enc_output: torch.Tensor, length: int) -> dict:
        """One decode row an image (sampling)."""
        return self.init_beam_cache(enc_output, 1, length)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: int, cache: dict, src=None):
        """(B·beam,) ``tokens`` at step ``pos`` → logits (B·beam, vocab) in the
        compute dtype, and the cache (its latents written in place)."""
        if pos == 0:   # the prefill read <start>
            return cache["logits"].repeat_interleave(cache["beam"], 0), cache
        lm, dt = self.language_model, self.dtype
        at = cache["prefix"][0].shape[1] - 1 + pos
        # arange, not a tensor of a Python list: a copy from the host waits for the card
        cos, sin = lm.rope(torch.arange(at, at + 1, device=tokens.device))
        h = lm.embed_tokens(tokens).float()
        for layer, prefix, lat in zip(lm.layers, cache["prefix"], cache["latents"]):
            h = layer.decode(h, cos, sin, prefix, lat, pos, src, dt)
        return lm.head(h, dt), cache


def language_model_parameters(tc: dict) -> int:
    """The language model's parameter count, built on ``meta``."""
    with torch.device("meta"):
        return sum(p.numel() for p in LanguageModel(tc).parameters())


@torch.no_grad()
def init_language_model_(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """A seeded init of the projector and the language model, drawn from
    ``generator`` on their device: normal(0, ``std``) weights and
    embeddings (DeepSeek-V3's default ``initializer_range``), zero biases,
    unit norm scales, a zero correction bias."""
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, (RMSNorm, nn.LayerNorm)) and name == "weight":
                p.fill_(1.0)
            elif name in ("bias", "e_score_correction_bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)
