"""Caption one image file on the CUDA card and write the COCO-format result
list to ``<result_dir>/<name>_captions_result.json`` (the port's counterpart
of the repository's root ``test.py``, with the same flags).

    python -m fpn_mt_image_captioning_torch.test --image=test_1.jpeg
        [--transformer_weight_path=model_weights/multimodal_transformer.msgpack]
        [--beam_search_n=8] [any Config --key=value]

The weights are the Flax msgpack file ``transformer_weight_path`` that the JAX
package's ``Pipeline.save_weights`` writes (root ``train.py`` writes it there
at the end of training). Root ``test.py`` restores the Orbax checkpoint
instead, which the port cannot read: without the msgpack file this raises
where a checkpoint exists.
"""

from __future__ import annotations

import json
import os
import sys

from .config import Config
from .data.dataset import load_image
from .parallel.multihost import is_primary, maybe_initialize
from .train.pipeline import Pipeline

__all__ = ["main"]


def main(cfg: Config, image_file_path: str, *, device=None) -> list[dict]:
    """Caption ``image_file_path``; ``device`` as for ``Pipeline`` (the card
    unless ``"cpu"`` is asked for). In a launched world of ranks (with the
    mesh) every rank captions the image and the primary writes the file."""
    maybe_initialize(device)
    pipeline = Pipeline.from_config(cfg, device=device)
    print("Evaluating...")
    img, _ = load_image(image_file_path, None, cfg.image_input_size)
    results = pipeline.evaluate_img(img)
    if not is_primary():
        return results

    out = os.path.join(cfg.result_dir,
                       os.path.basename(image_file_path).split(".")[0] + "_captions_result.json")
    os.makedirs(cfg.result_dir, exist_ok=True)
    with open(out, "w") as outfile:
        json.dump(results, outfile)
    print(results[0]["caption"])
    return results


if __name__ == "__main__":
    _image, _passthrough = "test_1.jpeg", []
    for _arg in sys.argv[1:]:
        if _arg.startswith("--image="):
            _image = _arg.split("=", 1)[1]
        else:
            _passthrough.append(_arg)
    main(Config.from_flags(_passthrough), _image)
