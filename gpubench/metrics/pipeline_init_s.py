"""pipeline_init_s: the part of set-up, in s, spent building the captioner:
the program's ``pipeline.init`` span (``Pipeline.__init__``: the model, its
weights, their cast and packing for the card, and a training pipeline's
state; the median where a run builds more than one). None where the
program records no such span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    p50 = registry and registry.summary("pipeline.init").get("p50_ms")
    return p50 and p50 / 1e3
