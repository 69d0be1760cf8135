"""Train on the CUDA card (the port's counterpart of the training leg of the
repository's root ``train.py``):

    python -m fpn_mt_image_captioning_torch.train
        [--datadir=datasets/iuxray] [--epochs=100] [--batch_size=10]
        [any Config --key=value]

Builds the validation iterator and the training dataset (fitting or loading
the tokenizer), the training pipeline (restoring the latest checkpoint under
``transformer_checkpoint_path``: the port's own steps or the JAX package's
Orbax stores, so a JAX run resumes here; the saves are the port's), stores
``max_seq_len`` and the best epoch in the additional-info sidecar, then runs
the epoch loop:
a train step a batch (a short tail batch padded with zero rows to
``batch_size``, as the JAX package pads it: they add nothing to the loss and
enter the BatchNorm batch statistics as there), the epoch's mean loss, and
every ``n_epoch_to_evaluate`` epochs the BatchNorm re-estimation
(``bn_finalize_batches`` > 0), ``evaluate`` on the fused decode kernels, the
result file, CIDEr, the smart saver (an early stop ends the loop). ``loss``
and ``CIDEr`` go to a TensorBoard event file and ``scalars.jsonl`` under
``logs/transformer/<time>/train``. At the end it restores the checkpoint of
the best CIDEr saved (and warns when none was) and writes the float32
weights to ``transformer_weight_path`` as Flax msgpack, which the JAX
package's ``Pipeline.load_weights`` reads. With ``export_artifact_dir`` it
then exports the serving artifact of those weights there
(``export.export_serving``; a failure is printed, not raised: the weights
are saved by then). With ``profile_dir`` a ``StepTracer`` writes a
``torch.profiler`` trace of training steps 1 to 3 there (CPU and CUDA
activities, ``*.pt.trace.json``); each step's phases lie in it as named
``user_annotation`` ranges (``utils.profiling``): ``train.step`` over
``train.issue`` (``train.upload``, ``train.forward``, ``train.backward``,
``train.clip`` over ``train.clip.wait``, ``train.optimizer``) and
``train.readback``.

Without a checkpoint to restore, the pipeline boots its feature extractor
from the Keras ``.h5`` file ``retinanet_weight_path`` where one is given (a
missing file raises ``OSError`` before any step). A checkpoint that does not
fit the model raises before any step. ``--is_training=false`` runs the evaluation of
``fpn_mt_image_captioning_torch.evaluate``.

Several ranks, one process a card (NCCL; gloo with ``device="cpu"``)::

    python -m torch.distributed.run --nproc_per_node=N \
        -m fpn_mt_image_captioning_torch.train --mesh.enabled=true \
        [--mesh.model_axis_size=M] [any Config --key=value]

``maybe_initialize`` brings up the process group from the launcher's
environment; each rank trains on its shard of the corpus and evaluates its
shard of the validation split (``Pipeline.evaluate`` returns the global
result list on every rank). The primary rank alone writes the result file,
the logs, the sidecar, the checkpoints and the weight file; CIDEr is
computed there and shared (a barrier, then ``gather_rows``), so every rank
takes the same checkpoint and early-stop decision. A mesh run exports no
serving artifact (an artifact is one card's program: export from the weight
file).
"""

from __future__ import annotations

import json
import os
import sys
from datetime import datetime

import numpy as np

from ..config import Config
from ..data.dataset import (COCO_Images_ImageID, get_coco_images_dataset, load_additional_info,
                            store_additional_info)
from ..export import export_serving
from ..utils.profiling import StepTracer
from ..parallel.multihost import (barrier, gather_rows, is_primary, maybe_initialize,
                                  process_shard, world_size)
from ..utils.tensorboard import ScalarLogger, SummaryWriter
from .pipeline import Pipeline

__all__ = ["main"]


def pad_batch(img: np.ndarray, caption_token: np.ndarray, batch_size: int):
    """A tail batch zero-padded to ``batch_size`` rows."""
    pad = batch_size - img.shape[0]
    if pad <= 0:
        return img, caption_token
    return (np.concatenate([img, np.zeros((pad, *img.shape[1:]), img.dtype)]),
            np.concatenate([caption_token,
                            np.zeros((pad, caption_token.shape[1]), caption_token.dtype)]))


class _NoLog:
    """The logs of a rank that is not the primary."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def shared_cider(master: Pipeline, result_file: str) -> float:
    """CIDEr of ``result_file``: computed by the primary rank and shared
    with every rank (in one process, computed)."""
    if world_size() == 1:
        return master.metric_eval(result_file)
    local = np.array([master.metric_eval(result_file) if is_primary() else 0.0], np.float64)
    barrier("cider_share")
    return float(gather_rows(local)[0])


def main(cfg: Config, *, device=None) -> Pipeline | list[dict]:
    """Train (or, with ``is_training`` false, evaluate); ``device`` as for
    ``Pipeline`` (the card unless ``"cpu"`` is asked for). Returns the
    training pipeline (the evaluation's results)."""
    if not cfg.is_training:
        from ..evaluate import main as evaluate_main

        return evaluate_main(cfg, device=device)
    maybe_initialize(device)
    shard_index, shard_count = process_shard()
    val_datasets = COCO_Images_ImageID(cfg.datadir, cfg.datatype_val, cfg.n_val_dataset,
                                       image_size=cfg.image_input_size, seed=cfg.seed,
                                       shard_count=shard_count, shard_index=shard_index)
    additional_info = load_additional_info(cfg.additional_filename)
    key_epoch = "mt_epoch_" + os.path.basename(cfg.transformer_checkpoint_path)

    train_datasets, max_seq_len, _train_set_len = get_coco_images_dataset(
        cfg.datadir, cfg.datatype_train, cfg.n_train_dataset, config=cfg)
    master = Pipeline(cfg.tokenizer_filename, max_seq_len, cfg, device=device,
                      checkpoint_path=cfg.transformer_checkpoint_path)
    additional_info["max_seq_len"] = max_seq_len
    if is_primary():
        store_additional_info(additional_info, cfg.additional_filename)

    log_dir = f"logs/transformer/{datetime.now().strftime('%Y%m%d-%H%M%S')}/train"
    if is_primary():
        writer, jsonl = SummaryWriter(log_dir), ScalarLogger(os.path.join(log_dir,
                                                                          "scalars.jsonl"))
    else:
        writer = jsonl = _NoLog()

    start_epoch = 0
    if master.ckpt_manager.latest_step is not None:
        start_epoch = additional_info.get(key_epoch, additional_info.get("transformer_epoch", 0))

    try:
        from tqdm import tqdm
    except ImportError:  # tqdm optional
        tqdm = lambda x, **k: x

    tracer = StepTracer(cfg.profile_dir) if cfg.profile_dir else None
    global_step = 0
    try:
        # the tracer closes when the epoch loop ends, also by an exception
        # or Ctrl-C: the trace of the steps taken is still written
        try:
            for epoch in range(start_epoch, cfg.epochs):
                print(f"Epoch {epoch + 1} / {cfg.epochs}")
                epoch_losses = []
                bar = tqdm(train_datasets, total=len(train_datasets))
                for img, caption_token in bar:
                    if tracer is not None:
                        tracer.step(global_step)
                    global_step += 1
                    loss = master.train_step(*pad_batch(img, caption_token, cfg.batch_size))
                    epoch_losses.append(loss)
                    if hasattr(bar, "set_postfix"):
                        bar.set_postfix(loss=f"{loss:.4f}")

                mean_loss = sum(epoch_losses) / max(len(epoch_losses), 1)
                writer.scalar("loss", mean_loss, epoch)
                jsonl.scalar("loss", mean_loss, epoch)

                if (epoch + 1) % cfg.n_epoch_to_evaluate == 0:
                    if cfg.bn_finalize_batches > 0:
                        used = master.finalize_batch_stats(iter(train_datasets),
                                                           cfg.bn_finalize_batches)
                        print(f"BN stats finalized over {used} train batches")
                    print("Evaluating...")
                    results = master.evaluate(iter(val_datasets))
                    if is_primary():
                        os.makedirs(os.path.dirname(cfg.result_file) or ".", exist_ok=True)
                        with open(cfg.result_file, "w") as outfile:
                            json.dump(results, outfile)
                    if results:
                        cider = shared_cider(master, cfg.result_file)
                        writer.scalar("CIDEr", cider, epoch)
                        jsonl.scalar("CIDEr", cider, epoch)
                        should_break = master.smart_ckpt_saver(epoch + 1, cider, master.state_tree)
                        if should_break == -1:
                            break
                        elif should_break == 1:
                            additional_info[key_epoch] = master.smart_ckpt_saver.max_acc_epoch
                            if is_primary():
                                store_additional_info(additional_info, cfg.additional_filename)
                print()
        finally:
            if tracer is not None:
                tracer.close()

        # restore the step of the best CIDEr among the epochs actually saved:
        # the latest checkpoint can be a worse one (the saver's early-epoch
        # baseline reset allows a later save below the best)
        best_step = master.smart_ckpt_saver.best_saved_step
        if best_step is None and master.ckpt_manager.latest_step is None:
            print("WARNING: no CIDEr-improving checkpoint was ever saved — "
                  "exporting the FINAL-epoch weights, not a validated best")
        else:
            print("Saving Transformer weights for epoch "
                  f"{master.smart_ckpt_saver.max_acc_epoch}")
        restored = master.ckpt_manager.restore(master.state_tree(), step=best_step)
        if restored is not None:
            master.load_state_tree(restored)
        master.save_weights(cfg.transformer_weight_path)
        if cfg.export_artifact_dir and master.mesh is not None:
            print("export_artifact_dir: skipped (a mesh run; an artifact is one card's "
                  "program: export from the weight file with --mesh.enabled=false)")
        elif cfg.export_artifact_dir and is_primary():
            # the weights are saved above: a failed export must not turn a
            # finished training run into a failure
            try:
                meta = export_serving(master, cfg.export_artifact_dir)
                print(f"Exported serving artifact (batch={meta['batch']}, "
                      f"beam={meta['beam_n']}) to {cfg.export_artifact_dir}")
            except Exception as e:  # noqa: BLE001
                print(f"export_artifact_dir: export failed ({type(e).__name__}: {e}); the "
                      "weights are saved: run python -m fpn_mt_image_captioning_torch.export "
                      "on them")
    finally:
        writer.close()
        jsonl.close()
    return master


if __name__ == "__main__":
    main(Config.from_flags(sys.argv[1:]))
