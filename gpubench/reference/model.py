"""The plain float32 model of the FPN + multi-transformer captioner.

A frozen, self-contained copy of the port's eager modules, written so that a
reader can check it against the published architecture
(``samkoesnadi/fpn-MT-image-captioning``): MobileNetV2 or ResNet-50 taps
C3/C4/C5, the RetinaNet FPN with the reference's two deviations (the top-down
path upsamples the reduced maps; P6/P7 are stride-1 convs then a 2x max-pool),
the shared head trunks, the spatial co-attention, the UMV multi-view encoder
and a post-LN transformer decoder with an unscaled embedding.

Module and parameter names are the port's, so one state dict fits both.
Everything computes in float32 and runs NCHW. ``set_numerics(model, fn)``
puts ``fn`` on the inputs and weights of every product (convolutions,
dense layers, attention matmuls) and on the activations that the captioner
keeps in its compute dtype (the norms' inputs and outputs, the embedded
tokens): the
identity by default, and a rounding to a lower precision for the control
that the benchmark's limits are tested against (``numerics.py``). Nothing here imports the port, JAX or the
benchmark's other modules.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e9


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def set_numerics(model: nn.Module, fn) -> nn.Module:
    """Round the inputs and weights of every product of ``model`` by ``fn``."""
    for m in model.modules():
        if hasattr(m, "q"):
            m.q = fn
    return model


def positional_encoding(position: int, d_model: int) -> np.ndarray:
    """(position, d_model) sinusoidal table, float64 arithmetic then float32:
    sin on even dims, cos on odd."""
    pos = np.arange(position)[:, None]
    i = np.arange(d_model)[None, :]
    angles = pos / np.power(10000, (2 * (i // 2)) / np.float32(d_model))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return angles.astype(np.float32)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF "SAME": output ceil(n/s), the odd pad after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """Convolution with TF "SAME" padding."""

    q = staticmethod(_identity)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph, pw = _same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, self.stride, 0, 1, self.groups)


class Dense(nn.Linear):
    q = staticmethod(_identity)

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class LayerNorm(nn.LayerNorm):
    q = staticmethod(_identity)

    def __init__(self, d: int):
        super().__init__(d, eps=1e-6)

    def forward(self, x):
        return self.q(super().forward(self.q(x)))


class BatchNorm(nn.Module):
    """Batch normalization over NCHW channels. Inference uses the running
    statistics; training the batch's biased moments (``E[x²] − E[x]²``
    clamped at 0), and moves the running ones by ``m·ra + (1 − m)·batch``."""

    q = staticmethod(_identity)

    def __init__(self, c: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool = False):
        x = self.q(x)
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return self.q((x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None])


def max_pool_2x(x):
    if x.shape[2] < 2 or x.shape[3] < 2:
        return x.new_empty((*x.shape[:2], x.shape[2] // 2, x.shape[3] // 2))
    return F.max_pool2d(x, 2, 2)


def leaky_relu(x):
    return F.leaky_relu(x, 0.2)


class Dropout:
    """The dropout masks of one training step, drawn by the rule that the
    captioner states: each site draws from a generator on the tensor's
    device seeded with blake2b("seed/step/site"), keeps values under
    ``1 − rate`` and scales them by ``1 / (1 − rate)``."""

    def __init__(self, rate: float, seed: int, step: int, device):
        self.rate, self.seed, self.step = rate, seed, step
        self.generator = torch.Generator(device=device)

    def __call__(self, x, site: str):
        if self.rate == 0.0:
            return x
        digest = hashlib.blake2b(f"{self.seed}/{self.step}/{site}".encode(), digest_size=8).digest()
        self.generator.manual_seed(int.from_bytes(digest, "little") >> 1)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _drop(x, drop, site):
    return x if drop is None else drop(x, site)


# --------------------------------------------------------------------------
# backbones
# --------------------------------------------------------------------------
class _ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, act=None, eps=1e-3, momentum=0.999):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, groups=groups, bias=False)
        self.bn = BatchNorm(cout, eps, momentum)
        self.act = act

    def forward(self, x, train=False):
        x = self.bn(self.conv(x), train)
        return x if self.act is None else self.act(x)


def _divisible(v: float, d: int = 8) -> int:
    new = max(d, int(v + d / 2) // d * d)
    return new + d if new < 0.9 * v else new


class _InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, t):
        super().__init__()
        hidden = cin * t
        self.expand = _ConvBN(cin, hidden, 1, act=F.relu6) if t != 1 else None
        self.depthwise = _ConvBN(hidden, hidden, 3, stride, groups=hidden, act=F.relu6)
        self.project = _ConvBN(hidden, cout, 1)
        self.residual = stride == 1 and cin == cout

    def forward(self, x, train=False):
        h = x if self.expand is None else self.expand(x, train)
        h = self.project(self.depthwise(h, train), train)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """MobileNetV2 (Sandler et al. 2018, Table 2) tapped after block groups
    2 and 4 and at the 1×1 head: strides 8, 16, 32."""

    BLOCKS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, alpha: float = 1.0):
        super().__init__()
        cin = _divisible(32 * alpha)
        self.stem = _ConvBN(3, cin, 3, 2, act=F.relu6)
        self.names = []
        for gi, (t, c, n, s) in enumerate(self.BLOCKS):
            cout = _divisible(c * alpha)
            for bi in range(n):
                name = f"block_{gi}_{bi}"
                self.add_module(name, _InvertedResidual(cin, cout, s if bi == 0 else 1, t))
                self.names.append((name, gi))
                cin = cout
        last = _divisible(1280 * alpha) if alpha > 1.0 else 1280
        self.head = _ConvBN(cin, last, 1, act=F.relu6)
        self.tap_channels = (_divisible(32 * alpha), _divisible(96 * alpha), last)

    def forward(self, x, train=False, ckpt=False):
        x = _run(self.stem, x, train, ckpt)
        taps = {}
        for name, gi in self.names:
            x = _run(getattr(self, name), x, train, ckpt)
            taps[gi] = x
        return taps[2], taps[4], _run(self.head, x, train, ckpt)


class _Bottleneck(nn.Module):
    def __init__(self, cin, filters, stride, project):
        super().__init__()
        kw = dict(eps=1.001e-5, momentum=0.99)
        self.shortcut = _ConvBN(cin, 4 * filters, 1, stride, **kw) if project else None
        self.conv1 = _ConvBN(cin, filters, 1, stride, act=F.relu, **kw)
        self.conv2 = _ConvBN(filters, filters, 3, act=F.relu, **kw)
        self.conv3 = _ConvBN(filters, 4 * filters, 1, **kw)

    def forward(self, x, train=False):
        s = x if self.shortcut is None else self.shortcut(x, train)
        return F.relu(self.conv3(self.conv2(self.conv1(x, train), train), train) + s)


class ResNet(nn.Module):
    """ResNet v1 (He et al. 2016) as Keras builds it: the stride of a
    stage's first block on its first 1×1 conv and on the projection; the
    stem's 3×3 max pool pads "SAME" with −inf. Taps after stages 2, 3, 4."""

    DEPTHS = {50: (3, 4, 6, 3)}

    def __init__(self, depth: int = 50):
        super().__init__()
        self.stem = _ConvBN(3, 64, 7, 2, act=F.relu, eps=1.001e-5, momentum=0.99)
        self.names, cin = [], 64
        for stage, n in enumerate(self.DEPTHS[depth]):
            names, filters = [], 64 * 2**stage
            for b in range(n):
                name = f"stage{stage}_block{b}"
                self.add_module(name, _Bottleneck(cin, filters, 2 if stage and not b else 1,
                                                  b == 0))
                names.append(name)
                cin = 4 * filters
            self.names.append(names)
        self.tap_channels = (512, 1024, 2048)

    def forward(self, x, train=False, ckpt=False):
        x = _run(self.stem, x, train, ckpt)
        (ht, hb), (wl, wr) = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)
        taps = []
        for names in self.names:
            for name in names:
                x = _run(getattr(self, name), x, train, ckpt)
            taps.append(x)
        return taps[1], taps[2], taps[3]


def backbone(name: str) -> nn.Module:
    if name.startswith("mobilenet"):
        return MobileNetV2(float(name.split("_")[1]) if "_" in name else 1.0)
    if name.startswith("resnet"):
        return ResNet(int(name[len("resnet"):]))
    raise ValueError(f"no reference backbone {name!r}")


def _run(module, x, train, ckpt):
    """``module(x, train)``, under activation checkpointing when ``ckpt``
    and gradients are recorded (the training reference fits the card so)."""
    if ckpt and torch.is_grad_enabled():
        return checkpoint(module, x, train, use_reentrant=False)
    return module(x, train)


# --------------------------------------------------------------------------
# FPN, heads, co-attention
# --------------------------------------------------------------------------
def _upsample(x, hw):
    return x.repeat_interleave(hw[0] // x.shape[2], 2).repeat_interleave(hw[1] // x.shape[3], 3)


class FPN(nn.Module):
    def __init__(self, c3, c4, c5, f=256):
        super().__init__()
        self.C5_reduced, self.P5 = Conv(c5, f, 1), Conv(f, f, 3)
        self.C4_reduced, self.P4 = Conv(c4, f, 1), Conv(f, f, 3)
        self.C3_reduced, self.P3 = Conv(c3, f, 1), Conv(f, f, 3)
        self.P6_conv, self.P7_conv = Conv(f, f, 3), Conv(f, f, 3)

    def forward(self, C3, C4, C5):
        p5r = self.C5_reduced(C5)
        p5 = F.relu(self.P5(p5r))
        p4m = _upsample(p5r, C4.shape[2:]) + self.C4_reduced(C4)
        p4 = F.relu(self.P4(p4m))
        p3 = F.relu(self.P3(_upsample(p4m, C3.shape[2:]) + self.C3_reduced(C3)))
        p6 = max_pool_2x(F.relu(self.P6_conv(p5r)))
        p7 = max_pool_2x(F.relu(self.P7_conv(p6)))
        return [p3, p4, p5, p6, p7]


class _Trunk(nn.Module):
    def __init__(self, n, f):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv_{i}", Conv(f, f, 3))

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return x


class FeatureExtractor(nn.Module):
    def __init__(self, backbone_name, d_model, n_conv=2, f=256):
        super().__init__()
        self.backbone = backbone(backbone_name)
        self.fpn = FPN(*self.backbone.tap_channels, f)
        self.regression_trunk, self.classification_trunk = _Trunk(n_conv, f), _Trunk(n_conv, f)
        self.regression_final, self.classification_final = Conv(f, 1, 3), Conv(f, f, 3)
        self.fuse_conv1, self.fuse_conv2 = Conv(f, f, 3), Conv(f, d_model, 3)

    def level(self, p):
        score = self.regression_final(self.regression_trunk(p))
        hs = self.classification_final(self.classification_trunk(p))
        b, _, h, w = score.shape
        att = torch.softmax(score.reshape(b, h * w), dim=1).reshape(b, 1, h, w)
        out = leaky_relu(self.fuse_conv1(att * hs))
        return leaky_relu(self.fuse_conv2(max_pool_2x(out)))

    def forward(self, x, train=False, ckpt=False):
        taps = self.backbone(x, train, ckpt)
        if ckpt and torch.is_grad_enabled():
            return [checkpoint(self.level, p, use_reentrant=False) for p in self.fpn(*taps)]
        return [self.level(p) for p in self.fpn(*taps)]


# --------------------------------------------------------------------------
# attention, encoder, decoder
# --------------------------------------------------------------------------
class MultiViewAttention(nn.Module):
    """One cross-attention per non-baseline view, queried by the baseline,
    outputs summed; ``wq``/``wo`` (V, d, d) in (in, out) layout."""

    q = staticmethod(_identity)

    def __init__(self, views, d, heads):
        super().__init__()
        self.heads = heads
        self.wq, self.bq = nn.Parameter(torch.empty(views, d, d)), nn.Parameter(torch.zeros(views, d))
        self.wo, self.bo = nn.Parameter(torch.empty(views, d, d)), nn.Parameter(torch.zeros(views, d))

    def forward(self, base, sources, kv_w, kv_b, drop, site):
        q_ = self.q
        b, lq, d = base.shape
        h, dh = self.heads, d // self.heads
        out = 0
        for vi, x in enumerate(sources):
            q = (q_(base) @ q_(self.wq[vi]) + self.bq[vi]).reshape(b, lq, h, dh)
            kv = q_(x) @ q_(kv_w[vi]) + kv_b[vi]
            k, v = kv[..., :d].reshape(b, -1, h, dh), kv[..., d:].reshape(b, -1, h, dh)
            w = torch.softmax(torch.einsum("bqhe,blhe->bhql", q_(q), q_(k)) / math.sqrt(dh), -1)
            ctx = torch.einsum("bhql,blhe->bqhe", q_(w), q_(v)).reshape(b, lq, d)
            out = out + _drop(q_(ctx) @ q_(self.wo[vi]) + self.bo[vi], drop, f"{site}.view_{vi}")
        return out


class _FFN(nn.Module):
    def __init__(self, d, dff):
        super().__init__()
        self.ffn1, self.ffn2 = Dense(d, dff), Dense(dff, d)

    def forward(self, x):
        return self.ffn2(leaky_relu(self.ffn1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, dff, views):
        super().__init__()
        self.mva = MultiViewAttention(views, d, heads)
        self.ffn = _FFN(d, dff)
        self.layernorm1, self.layernorm2 = LayerNorm(d), LayerNorm(d)

    def forward(self, base, sources, kv_w, kv_b, drop=None, site="encoder.layer"):
        out1 = self.layernorm1(base + self.mva(base, sources, kv_w, kv_b, drop, f"{site}.mva"))
        return self.layernorm2(out1 + _drop(self.ffn(out1), drop, f"{site}.dropout2"))


class Encoder(nn.Module):
    def __init__(self, layers, d, heads, dff, image_size, backbone_name, views=4, baseline=3):
        super().__init__()
        self.num_layers = layers
        self.feature_extractor = FeatureExtractor(backbone_name, d)
        for i in range(layers):
            self.add_module(f"layer_{i}", EncoderLayer(d, heads, dff, views))
        self.kv_proj = nn.Parameter(torch.empty(layers, views, d, 2 * d))
        self.kv_bias = nn.Parameter(torch.zeros(layers, views, 2 * d))
        self.layernorm1 = LayerNorm(d)
        self.pe = positional_encoding(math.ceil(image_size / 16) ** 2, d)
        self.order = [i for i in range(views + 1) if i != baseline] + [baseline]

    def forward(self, images, train=False, drop=None, ckpt=False):
        x = images.float() / 127.5 - 1.0 if images.dtype == torch.uint8 else images.float()
        views = self.feature_extractor(x.permute(0, 3, 1, 2), train, ckpt)
        emb = []
        for k, i in enumerate(self.order):
            t = views[i].flatten(2).transpose(1, 2)
            t = self.layernorm1(t) + torch.as_tensor(self.pe[: t.shape[1]], device=t.device)
            emb.append(_drop(t, drop, f"encoder.dropout1_{k}"))
        base, sources = emb[-1], emb[:-1]
        for li in range(self.num_layers):
            base = getattr(self, f"layer_{li}")(base, sources, self.kv_proj[li], self.kv_bias[li],
                                               drop, f"encoder.layer_{li}")
        return base


class MultiHeadAttention(nn.Module):
    q = staticmethod(_identity)

    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.wq, self.wk, self.wv, self.out = Dense(d, d), Dense(d, d), Dense(d, d), Dense(d, d)

    def forward(self, x, kv, mask=None):
        b, lq, d = x.shape
        h, dh = self.heads, d // self.heads
        q = self.wq(x).reshape(b, lq, h, dh)
        k, v = self.wk(kv).reshape(b, -1, h, dh), self.wv(kv).reshape(b, -1, h, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) / math.sqrt(dh)
        if mask is not None:
            logits = logits + mask * NEG_INF
        w = torch.softmax(logits, -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", self.q(w), self.q(v)).reshape(b, lq, d))


class DecoderLayer(nn.Module):
    def __init__(self, d, heads, dff):
        super().__init__()
        self.mha1, self.mha2 = MultiHeadAttention(d, heads), MultiHeadAttention(d, heads)
        self.ffn = _FFN(d, dff)
        self.layernorm1, self.layernorm2, self.layernorm3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)

    def forward(self, x, enc, mask, drop=None, site="decoder.layer"):
        out1 = self.layernorm1(_drop(self.mha1(x, x, mask), drop, f"{site}.dropout1") + x)
        out2 = self.layernorm2(_drop(self.mha2(out1, enc), drop, f"{site}.dropout2") + out1)
        return self.layernorm3(_drop(self.ffn(out2), drop, f"{site}.dropout3") + out2)


class Decoder(nn.Module):
    q = staticmethod(_identity)

    def __init__(self, layers, d, heads, dff, vocab, max_len):
        super().__init__()
        self.num_layers = layers
        self.embedding = nn.Embedding(vocab, d)
        self.pe = positional_encoding(max_len, d)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(d, heads, dff))

    def forward(self, tokens, enc, mask, drop=None):
        pe = torch.as_tensor(self.pe[: tokens.shape[1]], device=enc.device)
        h = _drop(self.q(self.embedding(tokens) + pe), drop, "decoder.dropout")
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, enc, mask, drop, f"decoder.layer_{i}")
        return h


class Transformer(nn.Module):
    """The captioner: ``encode`` images → (B, 16, d) at 512²; ``logits`` of a
    teacher-forced decode; ``forward_train`` the training forward (batch
    statistics, dropout)."""

    def __init__(self, cfg: dict, vocab: int, max_len: int):
        super().__init__()
        d, L, H, dff = cfg["d_model"], cfg["num_layers"], cfg["num_heads"], cfg["dff"]
        self.encoder = Encoder(L, d, H, dff, cfg["image_input_size"], cfg["backbone"])
        self.decoder = Decoder(L, d, H, dff, vocab, max_len)
        self.final_layer = Dense(d, vocab)

    def encode(self, images):
        return self.encoder(images)

    def logits(self, enc, tokens, pad_mask: bool = False, drop=None):
        """(B, L, V) logits of ``tokens`` (B, L) under the look-ahead mask
        (and the padding mask of id 0 where ``pad_mask``, as training has it)."""
        n = tokens.shape[1]
        mask = torch.triu(torch.ones(n, n, device=tokens.device), 1)
        if pad_mask:
            mask = torch.maximum(mask, (tokens == 0).float()[:, None, None, :])
        return self.final_layer(self.decoder(tokens, enc, mask, drop))

    def forward_train(self, images, tar_inp, drop=None, ckpt=False):
        enc = self.encoder(images, train=True, drop=drop, ckpt=ckpt)
        return self.logits(enc, tar_inp, pad_mask=True, drop=drop)
