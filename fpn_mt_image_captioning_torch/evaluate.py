"""Caption the validation split on the CUDA card and score it (the port's
counterpart of the ``--is_training=false`` leg of the repository's root
``train.py``): the same shuffled ``n_val_dataset`` images, the result list
written to ``cfg.result_file``, then ``name: value`` for BLEU-1..4, METEOR,
ROUGE-L and CIDEr-D.

    python -m fpn_mt_image_captioning_torch.evaluate
        [--transformer_weight_path=model_weights/multimodal_transformer.msgpack]
        [--datadir=datasets/iuxray] [--n_val_dataset=50] [any Config --key=value]

The weights are the Flax msgpack file ``transformer_weight_path`` of the JAX
package's ``Pipeline.save_weights`` or of the port's training (see
``test.py``). This module does not train: ``--is_training=true`` raises and
names ``python -m fpn_mt_image_captioning_torch.train``, the port's training
leg of root ``train.py``.

Several ranks (``python -m torch.distributed.run --nproc_per_node=N -m
fpn_mt_image_captioning_torch.evaluate --mesh.enabled=true ...``): each rank
captions its shard of the split, every rank gets the global result list,
and the primary alone writes the result file and prints the scores.
"""

from __future__ import annotations

import json
import os
import sys

from .config import Config
from .data.dataset import COCO_Images_ImageID
from .parallel.multihost import is_primary, maybe_initialize, process_shard
from .train.pipeline import Pipeline

__all__ = ["main"]


def main(cfg: Config, *, device=None) -> list[dict]:
    """Evaluate on ``cfg.datatype_val``; ``device`` as for ``Pipeline`` (the
    card unless ``"cpu"`` is asked for)."""
    if cfg.is_training:
        raise NotImplementedError("evaluate.py does not train: train with python -m "
                                  "fpn_mt_image_captioning_torch.train, or evaluate with "
                                  "--is_training=false")
    maybe_initialize(device)
    shard_index, shard_count = process_shard()
    val_datasets = COCO_Images_ImageID(cfg.datadir, cfg.datatype_val, cfg.n_val_dataset,
                                       image_size=cfg.image_input_size, seed=cfg.seed,
                                       shard_count=shard_count, shard_index=shard_index)
    pipeline = Pipeline.from_config(cfg, device=device)
    print("Evaluating...")
    results = pipeline.evaluate(iter(val_datasets))
    if not is_primary():
        return results
    os.makedirs(os.path.dirname(cfg.result_file) or ".", exist_ok=True)
    with open(cfg.result_file, "w") as outfile:
        json.dump(results, outfile)
    if results:
        pipeline.metric_eval(cfg.result_file)
        for name, value in pipeline.metric_eval.eval.items():
            print(f"{name}: {value:.4f}")
    return results


if __name__ == "__main__":
    main(Config.from_flags(sys.argv[1:], is_training=False))
