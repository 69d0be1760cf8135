"""Pipeline — the captioning surface of the port (inference side of
``fpn_mt_image_captioning_tpu/train/pipeline.py``).

``predict_batch`` encodes a batch of images and runs the batched beam search:
on the fused decode step (the hand-written kernels) by default, on the
non-fused KV-cached step (plain PyTorch) with ``Config.beam_parity_mode``
(the reference's tied-beam quirks) or ``use_pallas=False``, as the JAX
package routes them. ``sample_batch`` samples captions (temperature, top-k,
nucleus) on the non-fused step; ``predict_with_attention`` re-forwards a
caption teacher-forced for its attention weights, which
``plot_attention_weights`` draws. ``to_caption`` detokenizes; ``evaluate``
captions a validation split and ``metric_eval`` scores the result file
(BLEU-1..4, METEOR, ROUGE-L, CIDEr-D). With ``Config.fused_backbone`` (and
``use_pallas``) the encode runs the MobileNetV2 backbone as fused
inverted-residual kernels (``ops/fused_backbone.py``); a fault there raises,
it never falls back to the eager encode. Orbax checkpoint restore, training
and the multi-device paths are not ported yet.

Weights come from the JAX package (its variables tree as numpy arrays, or the
Flax msgpack file its ``Pipeline.save_weights`` writes: ``load_weights``, and
``from_config`` where ``Config.transformer_weight_path`` exists) or from a
seeded init. With ``Config.compute_dtype`` bfloat16 the weights the card runs
are cast once; LayerNorm, BatchNorm, softmax and beam scores stay float32.
``save_weights`` writes the served weights, so it needs a float32 pipeline.

The pipeline runs on ``device`` — by default the CUDA card; without one it
raises unless the caller asks for ``device="cpu"`` (which runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import functools
import math
import os
from collections.abc import Mapping

import numpy as np
import torch

from ..config import Config
from ..data.dataset import load_max_seq_len
from ..data.metrics import MetricEval
from ..data.tokenizer import Tokenizer, load_tokenizer_from_path
from ..decode.beam_search import beam_search, cast_for_inference, sample_decode
from ..models.positional import create_masks
from ..models.transformer import Transformer
from ..ops.fused_backbone import (fused_encode, pack_backbone_weights, packed_to,
                                  supports_fused_backbone)
from ..ops.fused_decoder import FUSED_ACTIVATIONS, pack_decoder_weights
from ..weights import from_flax, init_weights, read_flax_msgpack, to_flax, write_flax_msgpack

__all__ = ["Pipeline", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: a run
    that asked for the card never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Pipeline:
    # image batches may arrive as uint8 HWC bytes; encode normalizes on the device
    accepts_uint8 = True

    def __init__(
        self,
        tokenizer: Tokenizer | str,
        max_seq_len: int,
        config: Config | None = None,
        variables: Mapping | None = None,
        *,
        seed: int | None = None,
        device: str | torch.device | None = None,
    ):
        """``tokenizer``: a ``Tokenizer`` or the path of its JSON file.
        ``variables``: the JAX package's ``{"params", "batch_stats"}`` tree as
        numpy arrays; without it the weights come from a seeded init
        (``seed``, default ``config.seed``)."""
        cfg = self.config = config or Config()
        self.device = resolve_device(device)
        self.tokenizer = (load_tokenizer_from_path(tokenizer)
                          if isinstance(tokenizer, str) else tokenizer)
        self.max_seq_len = max_seq_len
        self.target_vocab_size = len(self.tokenizer.index_word)
        self.start_token = self.tokenizer.word_index["<start>"]
        self.end_token = self.tokenizer.word_index["<end>"]
        self.dtype = getattr(torch, cfg.compute_dtype)
        if variables is not None:
            self._load_variables(variables)
        else:
            model = self._new_model()
            init_weights(model, torch.Generator().manual_seed(cfg.seed if seed is None else seed))
            self._use(model)

    def _new_model(self) -> Transformer:
        """The float32 model on the CPU, its weights not yet set."""
        cfg = self.config
        with torch.device("meta"):
            model = Transformer(
                num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
                dff=cfg.dff, input_vocab_size=cfg.input_vocab_size,
                target_vocab_size=self.target_vocab_size, max_seq_len=self.max_seq_len,
                num_pyramids=cfg.num_of_pyramids, baseline_index=cfg.baseline_index,
                backbone_name=cfg.backbone, n_conv_submodule=cfg.n_conv_submodule,
                activation=cfg.activation,
            )
        return model.to_empty(device="cpu")

    def _use(self, model: Transformer) -> None:
        """Serve ``model`` (float32, on the CPU): cast, move and pack its
        weights for the card."""
        # the fused backbone folds BatchNorm from the float32 weights, before
        # the cast below (the JAX package folds float32 parameters too)
        cfg = self.config
        self.backbone_packed = None
        if cfg.use_pallas and cfg.fused_backbone and supports_fused_backbone(cfg.backbone):
            self.backbone_packed = packed_to(pack_backbone_weights(
                model.encoder.feature_extractor.backbone, self.dtype), self.device)
        self.transformer = cast_for_inference(model.eval(), self.dtype).to(self.device)
        self.packed = pack_decoder_weights(self.transformer, self.dtype)

    def _load_variables(self, variables: Mapping) -> None:
        """Serve the JAX package's ``{"params", "batch_stats"}`` tree; a tree
        that does not fit this model raises."""
        model = self._new_model()
        model.load_state_dict(from_flax(variables), strict=True)
        self._use(model)

    def load_weights(self, path: str) -> None:
        """Serve the weights of a Flax msgpack file (the JAX package's
        ``Pipeline.save_weights``, or this class's)."""
        self._load_variables(read_flax_msgpack(path))

    def save_weights(self, path: str) -> None:
        """Write the served weights as the Flax msgpack file that the JAX
        package's ``Pipeline.load_weights`` reads. A pipeline that computes in
        another dtype than float32 serves weights rounded from the float32 ones
        it was given, which it does not keep, so it raises."""
        if self.dtype != torch.float32:
            raise ValueError(
                f"save_weights: this pipeline serves {self.config.compute_dtype} weights "
                "rounded from float32 ones it does not keep; save from a pipeline with "
                "compute_dtype='float32'")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_flax_msgpack(path, to_flax(self.transformer))

    @classmethod
    def from_config(cls, cfg: Config, *, device: str | torch.device | None = None) -> "Pipeline":
        """The pipeline the entry points build: tokenizer from
        ``cfg.tokenizer_filename``, ``max_seq_len`` from
        ``cfg.additional_filename``, and the weights of the Flax msgpack file
        ``cfg.transformer_weight_path`` where it exists (root ``train.py``
        writes it at the end of training). Without it the JAX package restores
        the latest Orbax checkpoint under ``cfg.transformer_checkpoint_path``,
        or boots from ``cfg.retinanet_weight_path``; reading either is not
        ported, so where one exists this raises instead of serving seeded
        weights in its place. With neither, the weights are the seeded init,
        as there."""
        variables = None
        if os.path.isfile(cfg.transformer_weight_path):
            variables = read_flax_msgpack(cfg.transformer_weight_path)
        else:
            ckpt = cfg.transformer_checkpoint_path
            if ckpt and os.path.isdir(ckpt) and os.listdir(ckpt):
                raise NotImplementedError(
                    f"a checkpoint exists under {ckpt!r}, and reading Orbax checkpoints is "
                    "not ported yet; serving seeded weights in its place would be wrong. "
                    "Write the weights as Flax msgpack with the JAX package's "
                    "Pipeline.save_weights (train.py writes cfg.transformer_weight_path at "
                    f"the end of training; no file at {cfg.transformer_weight_path!r}) and "
                    "pass --transformer_weight_path=PATH")
            if cfg.retinanet_weight_path:
                raise NotImplementedError(
                    f"retinanet_weight_path={cfg.retinanet_weight_path!r}: importing Keras "
                    "RetinaNet weights is not ported yet")
        return cls(cfg.tokenizer_filename, load_max_seq_len(cfg.additional_filename), cfg,
                   variables, device=device)

    @functools.cached_property
    def metric_eval(self) -> MetricEval:
        """The scorer of ``cfg.datatype_val`` under ``cfg.datadir``, built on
        first use, so a pipeline starts without a dataset."""
        return MetricEval(self.config.datadir, self.config.datatype_val)

    def close(self) -> None:
        """Nothing to release (the JAX pipeline closes its checkpoint manager)."""

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        """(B, S, S, 3) uint8 or [-1, 1] float images → (B, Lenc, d_model)."""
        images = torch.as_tensor(np.asarray(images), device=self.device)
        if self.backbone_packed is not None:
            return fused_encode(self.transformer, self.backbone_packed, images)
        return self.transformer.encode(images)

    def predict_batch(self, images, beam_n: int | None = None):
        """Caption a batch of images, (B, S, S, 3) uint8 or float in [-1, 1].
        Returns (sequences (B, L) int32 np, lengths (B,) np).

        A batch whose decode rows (batch × beam) exceed
        ``Config.max_decode_rows`` is split into equal chunks, the tail
        zero-padded; beam search is batch-parallel, so chunking changes no
        result."""
        cfg = self.config
        beam_n = cfg.beam_search_n if beam_n is None else beam_n
        images = np.asarray(images)
        n_real = images.shape[0]
        limit = cfg.max_decode_rows
        if limit and n_real * beam_n > limit:
            chunk_b = max(1, limit // beam_n)
            parts = []
            for i in range(0, n_real, chunk_b):
                chunk = images[i : i + chunk_b]
                if chunk.shape[0] < chunk_b:
                    pad = np.zeros((chunk_b - chunk.shape[0], *chunk.shape[1:]), chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                parts.append(self._predict_chunk(chunk, beam_n))
            seqs = np.concatenate([p[0] for p in parts])[:n_real]
            lengths = np.concatenate([p[1] for p in parts])[:n_real]
            return seqs, lengths
        return self._predict_chunk(images, beam_n)

    def _predict_chunk(self, images: np.ndarray, beam_n: int):
        cfg = self.config
        # the fused decode step (the hand-written kernels on the card; their
        # plain versions on the CPU) freezes finished beams, which parity mode
        # must not; an activation the kernels do not implement takes the
        # non-fused step too
        fused = (cfg.use_pallas and not cfg.beam_parity_mode
                 and cfg.activation in FUSED_ACTIVATIONS)
        seqs, lengths, _scores = beam_search(
            self.transformer, self.encode(images),
            beam_n=beam_n, max_len=self.max_seq_len,
            start_token=self.start_token, end_token=self.end_token,
            parity=cfg.beam_parity_mode, fused=fused, packed=self.packed,
        )
        return seqs.cpu().numpy(), lengths.cpu().numpy()

    def sample_batch(self, images, *, seed: int = 0, temperature=1.0, top_k: int = 0,
                     top_p=None):
        """Stochastic captioning: ancestral sampling with temperature / top-k /
        nucleus truncation (``decode.beam_search.sample_decode``) on the
        non-fused step. ``temperature`` and ``top_p`` may be scalars or
        per-image arrays; ``top_p=None`` turns the nucleus (and its per-step
        sort) off. The noise comes from a ``torch.Generator`` on the
        pipeline's device seeded with ``seed``: the same seed on the same
        device gives the same captions. Returns (sequences (B, L) int32 np,
        lengths (B,) np)."""
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError("sample_batch over more than one process is not ported yet")
        images = np.asarray(images)
        n = images.shape[0]
        temperature = np.broadcast_to(np.asarray(temperature, np.float32), (n,)).copy()
        if top_p is not None:
            top_p = np.broadcast_to(np.asarray(top_p, np.float32), (n,)).copy()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        seqs, lengths = sample_decode(
            self.transformer, self.encode(images), generator,
            max_len=self.max_seq_len, start_token=self.start_token, end_token=self.end_token,
            temperature=temperature, top_k=top_k, top_p=top_p,
        )
        return seqs.cpu().numpy(), lengths.cpu().numpy()

    def predict(self, img, max_seq_len: int | None = None):
        """Single-image API: the stripped token sequence for one (S, S, 3) image."""
        del max_seq_len  # fixed at construction, kept for signature parity
        seqs, lengths = self.predict_batch(np.asarray(img)[None])
        return seqs[0][: lengths[0]]

    @torch.no_grad()
    def predict_with_attention(self, img, beam_n: int | None = None):
        """Caption one image and recover the decoder attention weights
        (``decoder_layer{n}_block{1,2}``, (1, H, L, L) and (1, H, L, Lenc)) by
        teacher-forcing ``<start>`` + the caption (cut to ``max_seq_len``)
        back through the decoder. Returns (token sequence, {name: float32
        numpy array})."""
        images = np.asarray(img)[None]
        seqs, lengths = self.predict_batch(images, beam_n=beam_n)
        seq = seqs[0][: lengths[0]]
        tokens = np.concatenate([[self.start_token], seq])[: self.max_seq_len]
        tar = torch.as_tensor(tokens, dtype=torch.long, device=self.device)[None, :]
        _logits, attention = self.transformer(self.encode(images), tar, create_masks(tar))
        return seq, {k: v.float().cpu().numpy() for k, v in attention.items()}

    def to_caption(self, seq_row, length) -> str:
        """Detokenize one decoded row (first ``length`` tokens) to a caption."""
        tokens = [int(t) for t in seq_row[:length]]
        return self.tokenizer.sequences_to_texts([tokens])[0]

    # the JAX package's older name (kept for parity with its signatures)
    _to_caption = to_caption

    def evaluate(self, generator) -> list[dict]:
        """Caption every (img, imgId) of ``generator``: a
        ``COCO_Images_ImageID`` decodes in batches of ``Config.decode_batch``
        (uint8, the padded tail dropped), any other iterable of (img, imgId)
        one image at a time. Returns ``[{"image_id", "caption"}, ...]``.

        Evaluating a corpus sharded over several processes is not ported."""
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError("evaluate over more than one process is not ported yet")
        results = []
        batch = max(self.config.decode_batch, 1)
        if hasattr(generator, "iter_batches") and batch > 1:
            for imgs, img_ids, valid in generator.iter_batches(batch,
                                                               as_uint8=self.accepts_uint8):
                seqs, lengths = self.predict_batch(imgs)
                for i in range(valid):
                    results.append({"image_id": img_ids[i],
                                    "caption": self.to_caption(seqs[i], lengths[i])})
            return results
        for img, img_id in generator:
            seqs, lengths = self.predict_batch(np.asarray(img)[None])
            results.append({"image_id": img_id, "caption": self.to_caption(seqs[0], lengths[0])})
        return results

    def evaluate_img(self, img) -> list[dict]:
        """One image's result list, ``[{"image_id": 0, "caption"}]``."""
        seqs, lengths = self.predict_batch(np.asarray(img)[None])
        return [{"image_id": 0, "caption": self.to_caption(seqs[0], lengths[0])}]

    def plot_attention_weights(self, attention, input_tokens, caption_token, layer: str,
                               filename: str, max_len: int = 10) -> None:
        """One head a panel of ``attention[layer]``'s first ``max_len`` query
        and key positions, written to ``filename`` (PNG). Needs matplotlib,
        which is imported here and nowhere else."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        att = np.asarray(attention[layer])
        if att.ndim == 4:
            att = att[0]
        att = att[:, :max_len, :max_len]
        input_tokens = list(input_tokens)[:max_len]
        caption_token = list(caption_token)[:max_len]

        fig = plt.figure(figsize=(16, 8))
        row = math.ceil(att.shape[0] ** 0.5)
        for head in range(att.shape[0]):
            ax = fig.add_subplot(row, row, head + 1)
            ax.matshow(att[head][:-1, :], cmap="viridis")
            fontdict = {"fontsize": 10}
            ax.set_xticks(range(len(input_tokens)))
            ax.set_yticks(range(len(caption_token)))
            ax.set_ylim(len(caption_token) - 1.5, -0.5)
            ax.set_xticklabels(list(map(str, input_tokens)), fontdict=fontdict, rotation=90)
            ax.set_yticklabels(
                [self.tokenizer.index_word.get(int(i), "?") for i in caption_token],
                fontdict=fontdict)
            ax.set_xlabel(f"Head {head + 1}")
        plt.tight_layout()
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        plt.savefig(filename)
        plt.close()
