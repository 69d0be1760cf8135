"""The plain float32 captioner of the ``kimi_vl_a3b_resnet50`` configuration:
the FPN-MT encoder of ``model.py`` (imported, unchanged), Kimi-VL's MLP
projector at merge kernel 1×1, and Kimi-VL-A3B's language model
(``moonshotai/Kimi-VL-A3B-Instruct``, its ``text_config``), written from the
published equations:

* projector: ``LayerNorm(d_model, eps 1e-5) → Linear → GELU → Linear(→
  hidden)``, with biases;
* the sequence ``[v_0 … v_15, <start>, w_1 …]`` at positions 0, 1, 2, …,
  causal over the whole of it;
* a layer: ``h += Attn(RMSNorm(h))``, ``h += FFN(RMSNorm(h))``; then
  ``RMSNorm`` and ``lm_head`` (no bias);
* attention (MLA, no query low-rank): ``q = W_q h`` split into ``q_nope``
  and ``q_pe`` per head; ``[c, k_pe] = W_kva h``; ``c`` normalised;
  ``[k_nope, v] = W_kvb c`` per head, decompressed for every position;
  RoPE (the pairs de-interleaved, then rotate-half) on ``q_pe`` and on
  ``k_pe``, which every head shares; softmax of ``[q_nope, q_pe]·[k_nope,
  k_pe] / √(nope + rope)``; ``W_o`` over the heads' ``v``;
* the experts (layers ``first_k_dense_replace`` on): ``s = sigmoid(W_r
  h)``; the top ``num_experts_per_tok`` by ``s + e_score_correction_bias``;
  weights ``s`` of those, normalised to sum 1 (+1e-20), times
  ``routed_scaling_factor``; ``Σ w_i E_i(h)`` by a loop over the experts,
  plus the shared experts as one MLP; a dense MLP before them.

No cache, no absorbed weights, no grouped product: each call recomputes the
whole sequence. Parameter names are the port's
(``fpn_mt_image_captioning_torch/models/kimi_vl.py``), so one state dict fits
both. The weights may be held in another dtype (the bfloat16 values the
captioner serves); each product takes them in float32. ``set_numerics``
(``model.py``) rounds the inputs and weights of every product, as it does
for the encoder. TF32 is turned off by its first call. Nothing here
imports the port, JAX or the benchmark's other modules."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .model import Encoder, _identity


def _no_tf32():
    """Float32 products in float32: TF32 off from the reference's first call on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Linear(nn.Linear):
    q = staticmethod(_identity)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.float()
        return F.linear(self.q(x), self.q(self.weight.float()), bias)


class RMSNorm(nn.Module):
    def __init__(self, d, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()


def rope(x, positions, theta):
    """RoPE of ``x`` (..., n, d) at ``positions`` (n,): pairs de-interleaved
    ((d/2, 2) → (2, d/2)), then ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + half * sin


class Attention(nn.Module):
    q = staticmethod(_identity)

    def __init__(self, tc):
        super().__init__()
        d, self.h = tc["hidden_size"], tc["num_attention_heads"]
        self.r, self.nope = tc["kv_lora_rank"], tc["qk_nope_head_dim"]
        self.pe, self.vd, self.theta = tc["qk_rope_head_dim"], tc["v_head_dim"], tc["rope_theta"]
        self.q_proj = Linear(d, self.h * (self.nope + self.pe), bias=False)
        self.kv_a_proj_with_mqa = Linear(d, self.r + self.pe, bias=False)
        self.kv_a_layernorm = RMSNorm(self.r, tc["rms_norm_eps"])
        self.kv_b_proj = Linear(self.r, self.h * (self.nope + self.vd), bias=False)
        self.o_proj = Linear(self.h * self.vd, d, bias=False)

    def forward(self, x, positions, mask):
        b, n, _ = x.shape
        q = self.q_proj(x).view(b, n, self.h, self.nope + self.pe).transpose(1, 2)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.r, self.pe], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, n, self.h, self.nope + self.vd)
        k_nope, v = kv.transpose(1, 2).split([self.nope, self.vd], -1)
        q = torch.cat([q[..., : self.nope], rope(q[..., self.nope:], positions, self.theta)], -1)
        k_pe = rope(k_pe[:, None], positions, self.theta).expand(b, self.h, n, self.pe)
        k = torch.cat([k_nope, k_pe], -1)
        scores = self.q(q) @ self.q(k).transpose(-1, -2) / (self.nope + self.pe) ** 0.5 + mask
        out = self.q(torch.softmax(scores, -1)) @ self.q(v)
        return self.o_proj(out.transpose(1, 2).reshape(b, n, self.h * self.vd))


class MLP(nn.Module):
    def __init__(self, d, width):
        super().__init__()
        self.gate_proj = Linear(d, width, bias=False)
        self.up_proj = Linear(d, width, bias=False)
        self.down_proj = Linear(width, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Gate(nn.Module):
    q = staticmethod(_identity)

    def __init__(self, tc):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(tc["n_routed_experts"], tc["hidden_size"]))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(tc["n_routed_experts"]))


class Experts(nn.Module):
    q = staticmethod(_identity)

    def __init__(self, tc):
        super().__init__()
        e, d, w = tc["n_routed_experts"], tc["hidden_size"], tc["moe_intermediate_size"]
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * w, d))   # gate rows, then up rows
        self.down_proj = nn.Parameter(torch.empty(e, d, w))


class MoE(nn.Module):
    def __init__(self, tc):
        super().__init__()
        self.k, self.scale = tc["num_experts_per_tok"], tc["routed_scaling_factor"]
        self.gate = Gate(tc)
        self.experts = Experts(tc)
        self.shared_experts = MLP(tc["hidden_size"],
                                  tc["moe_intermediate_size"] * tc["n_shared_experts"])

    def forward(self, x):
        shape, x = x.shape, x.reshape(-1, x.shape[-1])
        g, ex = self.gate, self.experts
        s = torch.sigmoid(F.linear(g.q(x), g.q(g.weight.float())))
        chosen = torch.topk(s + g.e_score_correction_bias.float(), self.k, dim=-1).indices
        w = s.gather(-1, chosen)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * self.scale
        y = torch.zeros_like(x)
        width = ex.down_proj.shape[-1]
        # the (token, choice) pairs by expert; their counts read once a layer
        order = torch.argsort(chosen.flatten(), stable=True)
        counts = torch.bincount(chosen.flatten(), minlength=ex.gate_up_proj.shape[0]).tolist()
        ends = torch.tensor(counts).cumsum(0).tolist()
        for e, (n, end) in enumerate(zip(counts, ends)):
            if n == 0:
                continue
            pairs = order[end - n: end]
            tok, slot = pairs // self.k, pairs % self.k
            w_gate, w_up = ex.gate_up_proj[e].float().split(width, 0)
            xe = ex.q(x[tok])
            he = F.silu(xe @ ex.q(w_gate).T) * (xe @ ex.q(w_up).T)
            out = ex.q(he) @ ex.q(ex.down_proj[e].float()).T
            y.index_add_(0, tok, out * w[tok, slot, None])
        return (y + self.shared_experts(x)).reshape(shape)


class Layer(nn.Module):
    def __init__(self, tc, i):
        super().__init__()
        d, eps = tc["hidden_size"], tc["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = Attention(tc)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = MoE(tc) if i >= tc["first_k_dense_replace"] else MLP(d, tc["intermediate_size"])

    def forward(self, h, positions, mask):
        h = h + self.self_attn(self.input_layernorm(h), positions, mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class LanguageModel(nn.Module):
    def __init__(self, tc):
        super().__init__()
        d = tc["hidden_size"]
        self.embed_tokens = nn.Embedding(tc["vocab_size"], d)
        self.layers = nn.ModuleList(Layer(tc, i) for i in range(tc["num_hidden_layers"]))
        self.norm = RMSNorm(d, tc["rms_norm_eps"])
        self.lm_head = Linear(d, tc["vocab_size"], bias=False)

    def forward(self, x):
        n = x.shape[1]
        positions = torch.arange(n, device=x.device)
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for layer in self.layers:
            x = layer(x, positions, mask)
        return self.norm(x)


class Projector(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.pre_norm = nn.LayerNorm(d_in, eps=1e-5)
        self.linear_1 = Linear(d_in, d_in)
        self.linear_2 = Linear(d_in, d_out)

    def forward(self, x):
        n = self.pre_norm
        x = F.layer_norm(x, n.normalized_shape, n.weight.float(), n.bias.float(), n.eps)
        return self.linear_2(F.gelu(self.linear_1(x)))


class Captioner(nn.Module):
    """``encode`` images → (B, 16, d_model) at 512²; ``logits`` (N, L,
    vocab) after each of ``tokens`` (N, L) (``<start>`` first) following
    the encoder output's visual prefix."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["d_model"]
        self.encoder = Encoder(cfg["num_layers"], d, cfg["num_heads"], cfg["dff"],
                               cfg["image_input_size"], cfg["backbone"])
        self.multi_modal_projector = Projector(d, cfg["hidden_size"])
        self.language_model = LanguageModel(cfg)

    def encode(self, images):
        _no_tf32()
        return self.encoder(images)

    def logits(self, enc, tokens):
        _no_tf32()
        lm = self.language_model
        visual = self.multi_modal_projector(enc.float())
        x = torch.cat([visual, lm.embed_tokens.weight[tokens].float()], 1)
        return lm.lm_head(lm(x)[:, visual.shape[1]:])
