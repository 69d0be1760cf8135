"""Typed configuration of the FPN Multi-Transformer captioning port.

The port's own copy of ``fpn_mt_image_captioning_tpu/config.py``: the same
frozen dataclass with the same fields and defaults, so one ``Config`` means the
same model in both packages. The defaults reproduce the original reference's
constants module (``common/common_definitions.py:6-70``); the knobs after
"accelerator knobs" (mesh axes, dtypes, decode batching) have no reference
counterpart. Some of them steer parts of the JAX package that the port has not
reached yet (mesh, remat, export, profiling); they are kept
so a ``Config`` built for either package is accepted by both.

One field is the port's alone, and the JAX package has no counterpart:
``language_model``, the published ``text_config`` of a language model that
takes the transformer decoder's place (Kimi-VL-A3B's, ``models/kimi_vl.py``:
its keys verbatim, ``models.kimi_vl.TEXT_CONFIG_KEYS``). Set, the captioner
is the FPN-MT encoder, Kimi-VL's projector and that language model, served
in ``compute_dtype`` on the card; it captions and samples, and does not
train.

Unlike the reference, nothing here is global mutable state: construct a ``Config``
(optionally overriding fields), pass it down. ``Config.from_flags`` provides CLI
overrides (``--key=value``) for the entry-point scripts.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from typing import Any, Sequence

__all__ = ["Config", "MeshConfig"]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding configuration (new in the JAX package; the reference
    is single-device — SURVEY.md §2.5).

    Axes:
      * ``data``  — data parallelism (batch axis sharding).
      * ``model`` — tensor parallelism (attention heads / dff sharding).

    ``data_axis_size * model_axis_size`` must equal ``jax.device_count()`` when a
    mesh is built; ``-1`` for ``data_axis_size`` means "all remaining devices".
    """

    data_axis: str = "data"
    model_axis: str = "model"
    data_axis_size: int = -1
    model_axis_size: int = 1
    # When True, Pipeline builds the mesh and runs DP(xTP)-sharded train/eval;
    # batches are zero-padded to a multiple of the data-axis size (padded rows
    # carry empty captions, so they contribute nothing to the loss/gradients).
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- run mode (reference common_definitions.py:6-12) ----
    is_training: bool = True
    logging_level: int = logging.DEBUG
    top_k: int = 10_000           # tokenizer num_words cap
    seed: int = 0

    # ---- model-wide activation/init (reference :14-15) ----
    activation: str = "leaky_relu"          # tf.nn.leaky_relu (alpha=0.2 TF default)
    leaky_relu_alpha: float = 0.2
    kernel_initializer: str = "he_normal"

    # ---- core hyperparameters (reference :18-32) ----
    image_input_size: int = 512
    batch_size: int = 10
    buffer_size: int = 1000                 # shuffle buffer
    epochs: int = 100
    beam_search_n: int = 4                  # README best run used 8
    n_val_dataset: int | None = 50
    n_train_dataset: int | None = None
    n_epoch_to_evaluate: int = 1
    amount_of_validation: int = 100         # for convert_dataset val/train split
    dropout_rate: float = 0.1
    gap_of_dead_epoch: int = 25
    warm_up_steps: int = 4000

    # ---- dataset locations (reference :42-53) ----
    datadir: str = "datasets/iuxray"
    datatype_val: str = "val2017"
    datatype_train: str = "train2017"
    tokenizer_filename: str = "datasets/_tokenizer.json"
    additional_filename: str = "datasets/_additional_extractor.json"
    retinanet_weight_path: str | None = None   # reference: COCO-pretrained .h5; TF-free here
    transformer_weight_path: str = "model_weights/multimodal_transformer.msgpack"
    transformer_checkpoint_path: str = "checkpoints/train/multimodal_transformer"
    result_dir: str = "results"

    # ---- transformer hyperparameters (reference :56-59) ----
    num_layers: int = 6
    d_model: int = 512
    dff: int = 2048
    num_heads: int = 8

    # ---- RetinaNet / FPN (reference :62-67) ----
    backbone: str = "mobilenet224_1.0"
    num_of_classes: int = 80
    num_of_retinanet_filters: int = 256
    num_of_anchors: int = 9
    num_of_pyramids: int = 5
    n_conv_submodule: int = 2               # head-trunk depth kept before new final conv

    # ---- UMV encoder (reference :70) ----
    baseline_index: int = 3                 # P6-derived 16-token view is the output stream

    # ---- LR schedule parity quirk ----
    # The reference constructs CustomSchedule with dff (=2048), not d_model
    # (reference utils/pipeline.py:29). Kept as an explicit flag.
    schedule_uses_dff: bool = True

    # ---- accelerator knobs (no reference counterpart) ----
    bn_momentum: float | None = None        # BatchNorm running-stats momentum
                                            # override. None = each backbone's
                                            # Keras-faithful default (MobileNetV2
                                            # 0.999). The Keras default is tuned
                                            # for long pretrained runs; a short
                                            # FROM-SCRATCH run leaves inference
                                            # stats near their (0, 1) init, and
                                            # the eval-mode encoder collapses to
                                            # a constant function of its input
                                            # (round-4 verdict). Set ~0.9 for
                                            # from-scratch training, or use
                                            # bn_finalize_batches.
    bn_finalize_batches: int = 0            # if > 0, train.py recomputes the BN
                                            # running statistics as EXACT
                                            # population moments over up to this
                                            # many train batches before every
                                            # evaluation (torch/Keras "BN
                                            # re-estimation"); the Keras-parity
                                            # momentum path is untouched. 0 = off
    compute_dtype: str = "bfloat16"         # matmul/conv compute dtype
    param_dtype: str = "float32"
    decode_batch: int = 16                  # images decoded per device step in eval
                                            # (iter_batches pads the tail batch)
    beam_parity_mode: bool = False          # reproduce reference prob-product/tied-beam quirks
    use_pallas: bool = True                 # fused decode step (hand-written kernels)
    fused_backbone: bool = False            # encode through the hand-written fused
                                            # MobileNetV2 block kernel
                                            # (ops/fused_backbone.py); off by default
    max_decode_rows: int = 512              # decode rows (batch*beam) per fused
                                            # decode launch; larger predict_batch
                                            # calls are chunked host-side. 0
                                            # disables chunking.
    dataset_cache: str = ""                 # decoded-image disk cache (the tf.data
                                            # ``.cache()`` equivalent): path prefix
                                            # for a uint8 memmap of the training
                                            # images after decode+resize — epoch 1
                                            # pays the PNG decode once, epochs 2+
                                            # stream at memory bandwidth. Empty = off
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    remat_encoder: bool = False             # jax.checkpoint over encoder layers
    export_artifact_dir: str = ""           # after training, also export the
                                            # best checkpoint as a compiled
                                            # serving artifact (export.py) into
                                            # this directory; empty = off
    profile_dir: str = ""                   # capture a jax.profiler device trace of
                                            # early train steps into this TensorBoard
                                            # logdir (SURVEY §5.1); empty = off
    # ---- the port's alone (no JAX counterpart) ----
    language_model: dict | None = dataclasses.field(default=None, hash=False)
                                            # a language model's published
                                            # text_config, which replaces the
                                            # decoder (models/kimi_vl.py);
                                            # None = the transformer decoder

    # ------------------------------------------------------------------
    @property
    def min_epoch_to_break(self) -> int:
        # reference common_definitions.py:30 — EPOCHS // 2
        return self.epochs // 2

    @property
    def input_vocab_size(self) -> int:
        # reference utils/pipeline.py:20 — PE table length == longest flattened view
        return math.ceil(self.image_input_size / 16) ** 2

    @property
    def result_file(self) -> str:
        # reference common_definitions.py:53
        return f"{self.result_dir}/{self.datatype_val}_captions_result.json"

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @classmethod
    def from_flags(cls, argv: Sequence[str] | None = None, **base: Any) -> "Config":
        """Build a Config from ``--key=value`` CLI overrides.

        Values are parsed as JSON when possible (so ``--batch_size=32`` gives an
        int, ``--beam_parity_mode=true`` a bool), else kept as strings.
        """
        import sys

        argv = list(sys.argv[1:] if argv is None else argv)
        overrides: dict[str, Any] = dict(base)
        mesh_overrides: dict[str, Any] = {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        mesh_fields = {f.name for f in dataclasses.fields(MeshConfig)}
        bool_fields = {f.name for f in dataclasses.fields(cls) if f.type in (bool, "bool")}
        bool_mesh_fields = {
            f.name for f in dataclasses.fields(MeshConfig) if f.type in (bool, "bool")
        }
        for arg in argv:
            if not arg.startswith("--"):
                continue
            key, had_eq, raw = arg[2:].partition("=")
            key = key.replace("-", "_")
            try:
                val = json.loads(raw)
            except (json.JSONDecodeError, ValueError):
                val = raw
            # nested mesh flags: --mesh.enabled=true, --mesh.model_axis_size=2
            if key.startswith("mesh."):
                sub = key[5:]
                if sub not in mesh_fields:
                    raise ValueError(f"Unknown mesh flag --{key}")
                if not had_eq:
                    # a bare boolean flag is a switch: --mesh.enabled == true.
                    # (Silently storing '' — falsy — used to ACCEPT the flag
                    # and then ignore it, quietly training single-device.)
                    if sub not in bool_mesh_fields:
                        raise ValueError(f"--{key} requires a value (--{key}=...)")
                    val = True
                mesh_overrides[sub] = val
                continue
            if key not in field_names:
                raise ValueError(f"Unknown config flag --{key}")
            if not had_eq:
                if key not in bool_fields:
                    raise ValueError(f"--{key} requires a value (--{key}=...)")
                val = True
            overrides[key] = val
        if mesh_overrides:
            mesh_base = overrides.get("mesh", MeshConfig())
            overrides["mesh"] = dataclasses.replace(mesh_base, **mesh_overrides)
        return cls(**overrides)
