"""Pipeline — the captioning surface of the port (inference side of
``fpn_mt_image_captioning_tpu/train/pipeline.py``).

``predict_batch`` encodes a batch of images and runs the batched beam search
on the fused decode step; ``to_caption`` detokenizes. Checkpoint restore,
training, ``evaluate`` and the multi-device paths are not ported yet.

Weights come either from the JAX package (its variables tree as numpy arrays,
through ``weights.from_flax``) or from a seeded init. With
``Config.compute_dtype`` bfloat16 the weights are cast once at construction;
LayerNorm, BatchNorm, softmax and beam scores stay float32.

The pipeline runs on ``device`` — by default the CUDA card; without one it
raises unless the caller asks for ``device="cpu"`` (which runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import Config
from ..data.tokenizer import Tokenizer, load_tokenizer_from_path
from ..decode.beam_search import beam_search, cast_for_inference
from ..models.transformer import Transformer
from ..ops.fused_decoder import FUSED_ACTIVATIONS, pack_decoder_weights
from ..weights import from_flax, init_weights

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

        with torch.device("meta"):
            model = Transformer(
                num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
                dff=cfg.dff, input_vocab_size=cfg.input_vocab_size,
                target_vocab_size=self.target_vocab_size, max_seq_len=max_seq_len,
                num_pyramids=cfg.num_of_pyramids, baseline_index=cfg.baseline_index,
                backbone_name=cfg.backbone, n_conv_submodule=cfg.n_conv_submodule,
                activation=cfg.activation,
            )
        model.to_empty(device="cpu")
        if variables is not None:
            model.load_state_dict(from_flax(variables), strict=True)
        else:
            init_weights(model, torch.Generator().manual_seed(cfg.seed if seed is None else seed))
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.transformer = cast_for_inference(model.eval(), self.dtype).to(self.device)
        self.packed = pack_decoder_weights(self.transformer, self.dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        """(B, S, S, 3) uint8 or [-1, 1] float images → (B, Lenc, d_model)."""
        return self.transformer.encode(torch.as_tensor(np.asarray(images), device=self.device))

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
        if cfg.beam_parity_mode or not cfg.use_pallas:
            raise NotImplementedError(
                "only the fused fast-mode beam search is ported (beam_parity_mode"
                " and use_pallas=False need the non-fused decode step)")
        if cfg.activation not in FUSED_ACTIVATIONS:
            raise NotImplementedError(f"activation {cfg.activation!r} has no fused kernel")
        seqs, lengths, _scores = beam_search(
            self.transformer, self.encode(images),
            beam_n=beam_n, max_len=self.max_seq_len,
            start_token=self.start_token, end_token=self.end_token, packed=self.packed,
        )
        return seqs.cpu().numpy(), lengths.cpu().numpy()

    def predict(self, img, max_seq_len: int | None = None):
        """Single-image API: the stripped token sequence for one (S, S, 3) image."""
        del max_seq_len  # fixed at construction, kept for signature parity
        seqs, lengths = self.predict_batch(np.asarray(img)[None])
        return seqs[0][: lengths[0]]

    def to_caption(self, seq_row, length) -> str:
        """Detokenize one decoded row (first ``length`` tokens) to a caption."""
        tokens = [int(t) for t in seq_row[:length]]
        return self.tokenizer.sequences_to_texts([tokens])[0]
