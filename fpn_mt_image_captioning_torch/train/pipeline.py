"""Pipeline — the captioning and training surface of the port (port of
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
it never falls back to the eager encode.

Training: a pipeline given ``checkpoint_path`` keeps a training state
(``TrainState``: the float32 master model on the device, the Keras-Adam
state, the step) and restores the latest of its checkpoints
(``train/checkpoint.py``, the port's own files) when it starts.
``train_step`` runs ``build_train_step_fn``'s step (loss, gradients,
per-variable clipping, AMSGrad, BatchNorm statistics);
``finalize_batch_stats`` re-estimates the BatchNorm statistics;
``state_tree``/``load_state_tree`` carry the state in the JAX ``TrainState``
layout. Captioning serves a cast and packed copy of the master weights,
made again from the current ones after the master changes. A checkpoint
directory may hold the JAX package's Orbax steps too, which restore alike
(``train/orbax_store.py`` reads them); the port saves its own files only.

Several ranks (``Config.mesh.enabled`` in a world of more than one rank,
``parallel/``): the pipeline builds the (data, model) mesh; a training
pipeline keeps its shards of the state (``parallel.train.shard_state``) and
steps on this rank's rows (``make_sharded_train_step``: the global batch is
every rank's rows, the loss returned is the global one);
``finalize_batch_stats`` takes the moments of the global chunks, as many on
every rank; ``predict_batch`` and ``sample_batch`` take this rank's rows and
return them, decoded with whole weights (the sampling noise drawn for the
global rows); ``evaluate`` decodes each rank's shard in lock step and
returns the global result list on every rank; ``state_tree`` and
``save_weights`` gather the shards, and the primary rank writes. A world of
one rank builds no mesh; a mesh the world cannot form raises.

Weights come from the JAX package (its variables tree as numpy arrays, or the
Flax msgpack file its ``Pipeline.save_weights`` writes: ``load_weights``, and
``from_config`` where ``Config.transformer_weight_path`` exists) or from a
seeded init. Without those weights (or a checkpoint to restore), a pipeline
boots as the JAX package does: the seeded init with the Keras RetinaNet
``.h5`` file ``Config.retinanet_weight_path`` imported into its feature
extractor where one is given (``load_pretrained_retinanet``, read by the
port's own HDF5 reader). With ``Config.compute_dtype`` bfloat16 the weights the card runs
are cast once; LayerNorm, BatchNorm, softmax and beam scores stay float32.
``save_weights`` writes the served weights, so it needs a float32 pipeline,
or the float32 master weights of a training pipeline.

The pipeline runs on ``device`` — by default the CUDA card; without one it
raises unless the caller asks for ``device="cpu"`` (which runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import functools
import itertools
import math
import os
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import load_max_seq_len
from ..data.metrics import MetricEval
from ..data.tokenizer import Tokenizer, load_tokenizer_from_path
from ..decode.beam_search import beam_search, cast_for_inference, sample_decode
from ..models.layers import BatchNorm32, Dropout
from ..models.positional import create_masks
from ..models.transformer import Transformer
from ..ops.fused_backbone import (fused_encode, pack_backbone_weights, packed_to,
                                  supports_fused_backbone)
from ..ops.fused_decoder import FUSED_ACTIVATIONS, pack_decoder_weights
from ..parallel.collectives import sum_tensors_
from ..parallel.mesh import make_mesh, mesh_shape
from ..parallel.multihost import (barrier, gather_rows, globalize_batch, is_primary, local_rank,
                                  rank, world_size)
from ..utils.profiling import annotate
from ..utils.weight_import import ImportReport, import_retinanet_weights
from ..weights import (from_flax, init_weights, read_flax_msgpack, to_flax,
                       train_state_from_flax, train_state_to_flax, write_flax_msgpack)
from .checkpoint import CheckpointManager, SmartCheckpointSaver
from .losses import masked_sparse_ce
from .schedule import (KerasAdamState, clip_by_per_variable_norm_, custom_schedule,
                       keras_adam_, keras_adam_init)

__all__ = ["Pipeline", "TrainState", "build_train_step_fn", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card (``cuda:LOCAL_RANK`` in a launched world
    of ranks), and raises when there is none: a run that asked for the card
    never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if "LOCAL_RANK" in os.environ:
            return torch.device("cuda", local_rank())
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _mesh_of(cfg: Config, device: torch.device):
    """The (data, model) mesh of ``cfg`` over the world, or None: without
    ``mesh.enabled``, and in a world of one rank (where a shape larger than
    one rank raises, as in a larger world a shape the world does not fill)."""
    if not cfg.mesh.enabled:
        return None
    if world_size() == 1:
        mesh_shape(cfg.mesh, 1)
        return None
    return make_mesh(cfg.mesh, device.type)


class TrainState(NamedTuple):
    model: Transformer          # float32 master weights and BatchNorm statistics
    opt_state: KerasAdamState
    step: int


def build_train_step_fn(learning_rate, *, seed: int, dropout_rate: float,
                        clipnorm: float = 1.0, data_group=None, model_group=None,
                        sharded: list[bool] | None = None):
    """The ``(state, img, caption_token) → (state, loss)`` training step:
    teacher-forced forward with BatchNorm in training mode (its running
    statistics updated in place) and dropout drawn from ``(seed, step)``,
    ``masked_sparse_ce``, gradients, per-variable clipping to ``clipnorm``,
    then Keras AMSGrad on the float32 master weights (in place).

    Over a mesh (``parallel.train.make_sharded_train_step``) the same body
    runs on a rank's data share: ``rows`` places the share in the global
    batch (the dropout masks), the loss counts the rows of the global batch,
    the gradients are summed over ``data_group`` before the clip, and the
    clip norm of each ``sharded`` gradient is its whole variable's (over
    ``model_group``). The loss returned is the global batch's."""

    def train_step(state: TrainState, img: torch.Tensor, caption_token: torch.Tensor,
                   rows: tuple[int, int] | None = None):
        tar_inp, tar_real = caption_token[:, :-1], caption_token[:, 1:]
        model = state.model
        with annotate("train.forward"):
            drop = Dropout(dropout_rate, seed, state.step, img.device, rows)
            logits, _ = model.forward_train(img, tar_inp, create_masks(tar_inp), drop)
            loss = masked_sparse_ce(tar_real, logits, data_group)
        params = list(model.parameters())
        with annotate("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            loss = loss.detach()
            sum_tensors_(grads + [loss], data_group)
        with annotate("train.clip"):
            clip_by_per_variable_norm_(grads, clipnorm, sharded, model_group)
        with annotate("train.optimizer"):
            opt_state = keras_adam_(params, grads, state.opt_state, learning_rate)
        return TrainState(model, opt_state, state.step + 1), loss

    return train_step


def _population_stats(per_batch: list[list[tuple[np.ndarray, np.ndarray]]]):
    """Per-batch BatchNorm moments, ``[[(mean, var) of each layer] of each
    batch]``, combined into population moments: ``M = E_k[m_k]``, ``V =
    E_k[v_k + m_k²] − M²``, exact for equal-size batches (float64, clamped
    at 0 against rounding). Returns ``[(mean, var) float32 of each layer]``."""
    out = []
    for layer in zip(*per_batch):
        m = np.stack([np.asarray(mean, np.float64) for mean, _ in layer])
        v = np.stack([np.asarray(var, np.float64) for _, var in layer])
        mean = m.mean(0)
        var = np.maximum((v + m * m).mean(0) - mean * mean, 0.0)
        out.append((mean.astype(np.float32), var.astype(np.float32)))
    return out


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
        checkpoint_path: str | None = None,
    ):
        """``tokenizer``: a ``Tokenizer`` or the path of its JSON file.
        ``variables``: the JAX package's ``{"params", "batch_stats"}`` tree as
        numpy arrays; without it the weights come from a seeded init
        (``seed``, default ``config.seed``), with the Keras ``.h5`` of
        ``config.retinanet_weight_path`` imported where one is given, as the
        JAX package boots. ``checkpoint_path``: the
        directory of this pipeline's checkpoints, which makes it a training
        pipeline; it restores the latest checkpoint there, if any."""
        with annotate("pipeline.init"):
            cfg = self.config = config or Config()
            self.device = resolve_device(device)
            self.mesh = _mesh_of(cfg, self.device)
            self._placements: dict = {}
            self.tokenizer = (load_tokenizer_from_path(tokenizer)
                              if isinstance(tokenizer, str) else tokenizer)
            self.max_seq_len = max_seq_len
            self.target_vocab_size = len(self.tokenizer.index_word)
            self.start_token = self.tokenizer.word_index["<start>"]
            self.end_token = self.tokenizer.word_index["<end>"]
            self.dtype = getattr(torch, cfg.compute_dtype)
            self.state: TrainState | None = None
            if checkpoint_path is None:
                model = self._initial_model(variables, seed)
                if variables is None and cfg.retinanet_weight_path:
                    self._boot_from_retinanet(model)
                self._use(model)
                return
            self.ckpt_manager = CheckpointManager(checkpoint_path, max_to_keep=100)
            self.smart_ckpt_saver = SmartCheckpointSaver(
                self.ckpt_manager, epochs=cfg.epochs, min_epoch_to_break=cfg.min_epoch_to_break,
                gap_of_dead_epoch=cfg.gap_of_dead_epoch)
            # the reference builds the schedule with dff, not d_model
            self.learning_rate = custom_schedule(
                cfg.dff if cfg.schedule_uses_dff else cfg.d_model, cfg.warm_up_steps)
            self._train_step = build_train_step_fn(self.learning_rate, seed=cfg.seed,
                                                   dropout_rate=cfg.dropout_rate)
            self.train_loss_history: list[float] = []
            master = self._initial_model(variables, seed).to(self.device)
            self.state = TrainState(master, keras_adam_init(list(master.parameters())), 0)
            restored = self.ckpt_manager.restore(self.state_tree())
            if restored is not None:
                self.load_state_tree(restored)
                print("Latest checkpoint restored!!")
            elif cfg.retinanet_weight_path:
                self._boot_from_retinanet(self.state.model)
            if self.mesh is not None:
                from ..parallel.train import make_sharded_train_step, shard_state

                self.state, self._placements = shard_state(
                    self.mesh, self.state, tp=cfg.mesh.model_axis_size > 1)
                self._train_step = make_sharded_train_step(
                    self.mesh, self.learning_rate, self._placements, seed=cfg.seed,
                    dropout_rate=cfg.dropout_rate)
            self._serve_master()

    def _initial_model(self, variables: Mapping | None, seed: int | None) -> Transformer:
        """The float32 model on the CPU with ``variables`` (a tree that does
        not fit it raises) or the seeded init."""
        model = self._new_model()
        if variables is not None:
            model.load_state_dict(from_flax(variables), strict=True)
        else:
            seed = self.config.seed if seed is None else seed
            init_weights(model, torch.Generator().manual_seed(seed))
        return model

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
                activation=cfg.activation, remat_encoder=cfg.remat_encoder,
                bn_momentum=cfg.bn_momentum, compute_dtype=self.dtype,
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
        # the sharded searches hold the old packed weights, and with them their graphs
        self.__dict__.pop("_sharded_beam_cache", None)

    @property
    def _sharded(self) -> bool:
        return any(d is not None for d in self._placements.values())

    def _whole_master(self) -> Transformer:
        """The master weights whole, in a float32 model on the CPU (under
        tensor parallelism a collective of the model group)."""
        from ..parallel.train import whole_state_dict

        model = self._new_model()
        model.load_state_dict(whole_state_dict(self.state.model))
        return model

    def _local(self, tensors):
        """This rank's shards of whole tensors (a state dict, or a list in
        the order of the parameters)."""
        if not self._sharded:
            return tensors
        from ..parallel.train import shard_tensor

        dims = self._placements
        if isinstance(tensors, Mapping):
            return {k: shard_tensor(t, dims.get(k), self.mesh) for k, t in tensors.items()}
        return [shard_tensor(t, d, self.mesh) for t, d in zip(tensors, dims.values())]

    def _whole(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Tensors in the order of the parameters (the optimizer's moments),
        gathered whole."""
        if not self._sharded:
            return tensors
        from ..parallel.collectives import gather_shards
        from ..parallel.mesh import model_group

        with torch.no_grad():
            return [t if d is None else gather_shards(t, model_group(self.mesh), d)
                    for t, d in zip(tensors, self._placements.values())]

    def _serve_master(self) -> None:
        """Serve the current master weights: copied whole to the CPU, then
        cast, moved and packed as weights given at construction are."""
        self._use(self._whole_master())
        self._stale = False

    def _sync(self) -> None:
        """Before captioning: serve the master weights again if they moved."""
        if self.state is not None and self._stale:
            self._serve_master()

    def load_weights(self, path: str) -> None:
        """Use the weights of a Flax msgpack file (the JAX package's
        ``Pipeline.save_weights``, or this class's): serve them, and in a
        training pipeline make them the master weights (the optimizer state
        and step stay)."""
        variables = read_flax_msgpack(path)
        if self.state is None:
            self._use(self._initial_model(variables, None))
            return
        self.state.model.load_state_dict(self._local(from_flax(variables)), strict=True)
        self._serve_master()

    def _import_retinanet(self, model: Transformer, h5_path) -> ImportReport:
        variables, report = import_retinanet_weights(
            to_flax(model), h5_path, n_conv_submodule=self.config.n_conv_submodule)
        model.load_state_dict(from_flax(variables), strict=True)
        return report

    def _boot_from_retinanet(self, model: Transformer) -> None:
        """The JAX package's boot: the seeded (or master) float32 ``model``
        with ``Config.retinanet_weight_path`` imported, the report printed."""
        report = self._import_retinanet(model, self.config.retinanet_weight_path)
        print(f"Loaded pretrained retinanet weights: {report!r}")

    def load_pretrained_retinanet(self, h5_path) -> ImportReport:
        """Import a Keras MobileNetV2-RetinaNet ``.h5`` (the reference's
        pretrained COCO detector; a path, or a ``{layer: {weight: array}}``
        dict already loaded) into the feature extractor: the backbone, FPN
        and head trunks it matches (``utils.weight_import``); the rest keeps
        its weights. A training pipeline imports into its float32 master
        weights; an inference one into the weights it serves, which are then
        cast, moved and packed again. Returns the import report; a missing
        file raises ``OSError``."""
        if self.state is not None:
            model = self._whole_master()
            report = self._import_retinanet(model, h5_path)
            self.state.model.load_state_dict(self._local(model.state_dict()))
            self._stale = True
            return report
        model = self._initial_model(to_flax(self.transformer), None)
        report = self._import_retinanet(model, h5_path)
        self._use(model)
        return report

    def save_weights(self, path: str) -> None:
        """Write the weights as the Flax msgpack file that the JAX package's
        ``Pipeline.load_weights`` reads: a training pipeline's float32 master
        weights, else the served ones. A pipeline that serves another dtype
        than float32 and keeps no master serves weights rounded from the
        float32 ones it was given, so it raises. Over several ranks every
        rank calls this (the shards are gathered) and the primary writes."""
        if self.state is None and self.dtype != torch.float32:
            raise ValueError(
                f"save_weights: this pipeline serves {self.config.compute_dtype} weights "
                "rounded from float32 ones it does not keep; save from a pipeline with "
                "compute_dtype='float32'")
        model = self.transformer if self.state is None else self._whole_master()
        if is_primary():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            write_flax_msgpack(path, to_flax(model))
        barrier("save_weights")

    # ------------------------------------------------------------------
    def state_tree(self) -> dict:
        """The training state as the JAX ``TrainState`` tree of numpy arrays
        (``weights.train_state_to_flax``), which the checkpoints store; whole
        under tensor parallelism (a collective of the model group)."""
        st = self.state
        opt = st.opt_state
        model = self._whole_master() if self._sharded else st.model
        return train_state_to_flax(model, opt.count, self._whole(opt.m), self._whole(opt.v),
                                   self._whole(opt.vhat), st.step)

    def load_state_tree(self, tree: Mapping) -> None:
        """Make ``tree`` (``state_tree``'s layout, whole) the training state;
        under tensor parallelism this rank keeps its shards."""
        model = self.state.model
        names = [name for name, _ in model.named_parameters()]
        sd, count, m, v, vhat, step = train_state_from_flax(tree, names)
        model.load_state_dict(self._local(sd), strict=True)
        to_dev = lambda ts: [t.to(self.device) for t in self._local(ts)]
        self.state = TrainState(model, KerasAdamState(count, to_dev(m), to_dev(v), to_dev(vhat)),
                                step)
        self._stale = True

    # ------------------------------------------------------------------
    @property
    def _data_axis_size(self) -> int:
        from ..parallel.mesh import axis_size

        return axis_size(self.mesh, 0)

    @property
    def _local_data_share(self) -> int:
        """The data-axis positions this process feeds: the local rows only
        need to divide it (the global batch is every process' rows)."""
        return max(1, self._data_axis_size // world_size())

    def _pad_batch(self, arr: np.ndarray) -> tuple[np.ndarray, int]:
        """Zero-pad this process' rows to a multiple of its data share."""
        pad = (-arr.shape[0]) % self._local_data_share
        if pad:
            arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
        return arr, pad

    def train_step(self, img, caption_token) -> float:
        """One optimizer step on a batch, (B, S, S, 3) uint8 or [-1, 1] float
        images and (B, L) caption token ids; returns the loss. The loss is
        read back, so the step has ended on the device when this returns.
        Over a mesh the batch is this rank's rows (zero-padded to its data
        share), every rank steps together, and the loss is the global
        batch's."""
        with annotate("train.step", cpu=True):
            with annotate("train.issue"):
                img, caption_token = np.asarray(img), np.asarray(caption_token, np.int64)
                if self.mesh is not None:
                    img, _ = self._pad_batch(img)
                    caption_token, _ = self._pad_batch(caption_token)
                with annotate("train.upload"):
                    img = torch.as_tensor(img, device=self.device)
                    caption_token = torch.as_tensor(caption_token, device=self.device)
                self.state, loss = self._train_step(self.state, img, caption_token)
                self._stale = True
            with annotate("train.readback", wait=True):
                loss = float(loss)
        self.train_loss_history.append(loss)
        return loss

    @torch.no_grad()
    def finalize_batch_stats(self, batches, n_batches: int | None = None) -> int:
        """Recompute the BatchNorm running statistics as exact population
        moments over training batches (BN re-estimation): each batch's exact
        moments from a pass of the feature extractor in training mode at
        momentum 0 (``ra = 0·ra + 1·batch``), combined by
        ``_population_stats``. ``batches``: image batches or ``(image,
        caption)`` pairs, uint8 or float; their rows are cut into chunks of
        the first batch's size (cut to a multiple of the local data share),
        without padding (the rows left over are not used), at most
        ``n_batches`` chunks. Returns the chunks used; 0 (the statistics
        untouched) when the model has no BatchNorm or the data fill no chunk.

        Over several processes each chunk's moments are the global batch's
        (every rank's chunk), so every rank must run as many: the chunks are
        cut first, and all take the smallest count of any rank."""
        model = self.state.model
        bns = [m for m in model.modules() if isinstance(m, BatchNorm32)]
        if not bns:
            return 0
        chunks = self._chunks(batches, self._local_data_share)
        if n_batches is not None:
            chunks = itertools.islice(chunks, n_batches)
        if world_size() > 1:
            local = list(chunks)
            chunks = local[: int(gather_rows(np.asarray([len(local)])).min())]
        per_batch, momenta = [], [bn.momentum for bn in bns]
        try:
            for bn in bns:
                bn.momentum = 0.0
            for rows in chunks:
                rows = torch.as_tensor(rows, device=self.device)
                if self.mesh is not None:
                    rows = globalize_batch(self.mesh, rows)
                model.encoder.features(rows, train=True)
                per_batch.append([(bn.running_mean.cpu().numpy(), bn.running_var.cpu().numpy())
                                  for bn in bns])
        finally:
            for bn, m in zip(bns, momenta):
                bn.momentum = m
        if not per_batch:
            return 0
        for bn, (mean, var) in zip(bns, _population_stats(per_batch)):
            bn.running_mean.copy_(torch.from_numpy(mean))
            bn.running_var.copy_(torch.from_numpy(var))
        self._stale = True
        return len(per_batch)

    @staticmethod
    def _chunks(batches, share: int = 1):
        """The image rows of ``batches`` in equal chunks of the first batch's
        size cut to a multiple of ``share`` (at least one share), as the JAX
        package re-chunks them."""
        chunk, buf, buffered = None, [], 0
        for item in batches:
            img = np.asarray(item[0] if isinstance(item, (tuple, list)) else item)
            if img.shape[0] == 0:
                continue
            if chunk is None:
                chunk = max(share, img.shape[0] // share * share)
            buf.append(img)
            buffered += img.shape[0]
            while buffered >= chunk:
                rows = np.concatenate(buf) if len(buf) > 1 else buf[0]
                yield rows[:chunk]
                rest = rows[chunk:]
                buf = [rest] if rest.shape[0] else []
                buffered = rest.shape[0]

    @classmethod
    def from_config(cls, cfg: Config, *, device: str | torch.device | None = None) -> "Pipeline":
        """The pipeline the entry points build: tokenizer from
        ``cfg.tokenizer_filename``, ``max_seq_len`` from
        ``cfg.additional_filename``, and the weights of the Flax msgpack file
        ``cfg.transformer_weight_path`` where it exists (root ``train.py``
        writes it at the end of training). Without it, as the JAX package's
        ``Pipeline`` does, the latest checkpoint under
        ``cfg.transformer_checkpoint_path``: the JAX package's Orbax stores
        and the port's own steps alike (``CheckpointManager.read``; its
        ``params`` and ``batch_stats``). Else the seeded init with the Keras
        RetinaNet ``.h5`` weights of ``cfg.retinanet_weight_path`` imported
        where it is given (a missing file raises ``OSError``), or the seeded
        init alone."""
        variables = None
        ckpt = cfg.transformer_checkpoint_path
        if os.path.isfile(cfg.transformer_weight_path):
            variables = read_flax_msgpack(cfg.transformer_weight_path)
        elif ckpt and os.path.isdir(ckpt):
            manager = CheckpointManager(ckpt)
            step = manager.latest_step
            if step is not None:
                tree = manager.read(step)
                variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
                print("Latest checkpoint restored!!")
        return cls(cfg.tokenizer_filename, load_max_seq_len(cfg.additional_filename), cfg,
                   variables, device=device)

    @functools.cached_property
    def metric_eval(self) -> MetricEval:
        """The scorer of ``cfg.datatype_val`` under ``cfg.datadir``, built on
        first use, so a pipeline starts without a dataset."""
        return MetricEval(self.config.datadir, self.config.datatype_val)

    def close(self) -> None:
        """Close the checkpoint manager of a training pipeline."""
        if self.state is not None:
            self.ckpt_manager.close()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        """(B, S, S, 3) uint8 or [-1, 1] float images → (B, Lenc, d_model)."""
        self._sync()
        images = np.asarray(images)
        with annotate("predict.upload"):
            images = torch.as_tensor(images, device=self.device)
        with annotate("predict.encode"):
            if self.backbone_packed is not None:
                return fused_encode(self.transformer, self.backbone_packed, images)
            return self.transformer.encode(images)

    def predict_batch(self, images, beam_n: int | None = None):
        """Caption a batch of images, (B, S, S, 3) uint8 or float in [-1, 1].
        Returns (sequences (B, L) int32 np, lengths (B,) np).

        A batch whose decode rows (batch × beam) exceed
        ``Config.max_decode_rows`` is split into equal chunks, the tail
        zero-padded; beam search is batch-parallel, so chunking changes no
        result.

        Over a mesh ``images`` is this rank's rows, and so is the result
        (``parallel.train.make_sharded_beam_search``: whole weights, no
        collective); every rank calls this with as many rows. In a world of
        several ranks without a mesh it raises, as the JAX package does."""
        with annotate("predict.call", cpu=True):
            cfg = self.config
            beam_n = cfg.beam_search_n if beam_n is None else beam_n
            self._refuse_ranks_without_mesh("predict_batch")
            images = np.asarray(images)
            n_real = images.shape[0]
            limit = cfg.max_decode_rows
            ndev = self._local_data_share
            if limit and -(-n_real // ndev) * beam_n > limit:
                chunk_b = max(1, limit // beam_n) * ndev
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

    def _refuse_ranks_without_mesh(self, what: str) -> None:
        if world_size() > 1 and self.mesh is None:
            raise NotImplementedError(
                f"{what} in a world of {world_size()} ranks needs the mesh "
                "(Config.mesh.enabled): without it no rank knows its rows' place")

    def _predict_chunk(self, images: np.ndarray, beam_n: int):
        cfg = self.config
        n_real, pad = images.shape[0], 0
        if self.mesh is not None:
            images, pad = self._pad_batch(images)
        self._sync()
        # the fused decode step (the hand-written kernels on the card; their
        # plain versions on the CPU) freezes finished beams, which parity mode
        # must not; an activation the kernels do not implement takes the
        # non-fused step too
        fused = (cfg.use_pallas and not cfg.beam_parity_mode
                 and cfg.activation in FUSED_ACTIVATIONS)
        enc = self.encode(images)
        if self.mesh is not None and fused:
            seqs, lengths, _scores = self._sharded_beam_search(beam_n)(enc)
        else:
            seqs, lengths, _scores = beam_search(
                self.transformer, enc,
                beam_n=beam_n, max_len=self.max_seq_len,
                start_token=self.start_token, end_token=self.end_token,
                parity=cfg.beam_parity_mode, fused=fused, packed=self.packed,
            )
        with annotate("predict.to_host", wait=True):
            return seqs[:n_real].cpu().numpy(), lengths[:n_real].cpu().numpy()

    def _sharded_beam_search(self, beam_n: int):
        """The sharded fused beam search of the served weights, by beam
        width (made again when the served weights are)."""
        from ..parallel.train import make_sharded_beam_search

        cache = self.__dict__.setdefault("_sharded_beam_cache", {})
        key = (beam_n, id(self.packed))
        if key not in cache:
            cache.clear()
            cache[key] = make_sharded_beam_search(
                self.mesh, self.transformer, beam_n=beam_n, max_len=self.max_seq_len,
                start_token=self.start_token, end_token=self.end_token, fused=True,
                packed=self.packed)
        return cache[key]

    def sample_batch(self, images, *, seed: int = 0, temperature=1.0, top_k: int = 0,
                     top_p=None):
        """Stochastic captioning: ancestral sampling with temperature / top-k /
        nucleus truncation (``decode.beam_search.sample_decode``) on the
        non-fused step. ``temperature`` and ``top_p`` may be scalars or
        per-image arrays; ``top_p=None`` turns the nucleus (and its per-step
        sort) off. The noise comes from a ``torch.Generator`` on the
        pipeline's device seeded with ``seed``: the same seed on the same
        device gives the same captions. Returns (sequences (B, L) int32 np,
        lengths (B,) np).

        Over a mesh ``images`` is this rank's rows and so is the result; the
        noise is drawn for the global rows (every rank's, in rank order) and
        each rank keeps its own, so the captions equal those of one process
        sampling the global batch. Without a mesh in a world of several
        ranks it raises."""
        self._refuse_ranks_without_mesh("sample_batch")
        images = np.asarray(images)
        n = images.shape[0]
        temperature = np.broadcast_to(np.asarray(temperature, np.float32), (n,)).copy()
        if top_p is not None:
            top_p = np.broadcast_to(np.asarray(top_p, np.float32), (n,)).copy()
        rows = None
        if self.mesh is not None:
            images, pad = self._pad_batch(images)
            temperature = np.concatenate([temperature, np.ones(pad, np.float32)])
            if top_p is not None:
                top_p = np.concatenate([top_p, np.ones(pad, np.float32)])
            counts = gather_rows(np.asarray([images.shape[0]]))
            rows = (int(counts[:rank()].sum()), int(counts.sum()))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self._sync()
        seqs, lengths = sample_decode(
            self.transformer, self.encode(images), generator,
            max_len=self.max_seq_len, start_token=self.start_token, end_token=self.end_token,
            temperature=temperature, top_k=top_k, top_p=top_p, rows=rows,
        )
        return seqs[:n].cpu().numpy(), lengths[:n].cpu().numpy()

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
        numpy array}). One process only, as in the JAX package."""
        if world_size() > 1:
            raise NotImplementedError("predict_with_attention runs in one process "
                                      "(show_results on one rank)")
        images = np.asarray(img)[None]
        seqs, lengths = self.predict_batch(images, beam_n=beam_n)
        seq = seqs[0][: lengths[0]]
        tokens = np.concatenate([[self.start_token], seq])[: self.max_seq_len]
        tar = torch.as_tensor(tokens, dtype=torch.long, device=self.device)[None, :]
        self._sync()
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

        In a world of several ranks ``generator`` is this rank's shard of the
        split (``COCO_Images_ImageID(..., shard_count, shard_index)``); every
        rank decodes in lock step and returns the global result list."""
        results = []
        batch = max(self.config.decode_batch, 1)
        d = self._data_axis_size
        batch = -(-batch // d) * d
        if world_size() > 1:
            return self._evaluate_ranks(generator, batch)
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

    def _evaluate_ranks(self, generator, batch: int) -> list[dict]:
        """Each rank decodes its shard in lock step: every round gathers a
        "still have rows" flag, and a rank whose shard has ended decodes a
        batch of zeros while another has rows; then the ids, token rows and
        lengths are gathered and detokenized on every rank, in rank order."""
        if not hasattr(generator, "iter_batches") or batch <= 1:
            raise NotImplementedError("evaluate over several ranks needs a batched iterator "
                                      "(COCO_Images_ImageID.iter_batches)")
        s = self.config.image_input_size
        dtype = np.uint8 if self.accepts_uint8 else np.float32
        it = generator.iter_batches(batch, as_uint8=self.accepts_uint8)
        ids, seqs_l, lens = [], [], []
        while True:
            imgs, img_ids, valid = next(it, (None, [], 0))
            if not gather_rows(np.asarray([int(valid > 0)])).any():
                break
            if imgs is None:
                imgs = np.zeros((batch, s, s, 3), dtype)
            seqs, lengths = self.predict_batch(imgs)
            ids += [int(i) for i in img_ids[:valid]]
            seqs_l += list(seqs[:valid])
            lens += [int(n) for n in lengths[:valid]]
        g_ids = gather_rows(np.asarray(ids, np.int64))
        g_seqs = gather_rows(np.asarray(seqs_l, np.int32).reshape(-1, self.max_seq_len))
        g_lens = gather_rows(np.asarray(lens, np.int32))
        return [{"image_id": int(i), "caption": self.to_caption(q, int(n))}
                for i, q, n in zip(g_ids, g_seqs, g_lens)]

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
